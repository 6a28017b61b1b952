"""Measure-many, pick-fastest autotuner of the ``ff_dense`` kernel's
tile, with a persisted tuning table (the port of
``repro.kernels.autotune``).

For each ``(M, K, N, dtype, platform, norm)`` shape bucket the tuner
times every registered ``ff_dense`` impl (a tunable one, the CUDA kernel
of ``csrc/ff_dense.cu``, at each tile of ``candidate_tiles``; the others,
the plain version, as one candidate each) through ONE forward + backward
step of the reference's loss ``vdot(y, cy) + vdot(g, cg)``, so the
backward kernel (``csrc/ff_dense_bwd.cu``, at its own split) and the
``dg`` path are part of what is timed and gated, and:

  * rejects a candidate whose scale-normalized value (y, g) or gradient
    (dx, dw, db) error against the plain version exceeds ``ERR_GATE``
    (the 1e-4 of the reference's tuner and of ``chip_smoke.py``'s
    grads): a fast but wrong tile never wins. The loss leaves out the
    entries whose pre-activation lies within the gate of relu's kink,
    where two correct forwards disagree on the gradient
    (``_tune_data``);
  * drops a tile over the shared memory a block may use
    (``ff_dense.smem_block_bytes`` <= ``SMEM_BUDGET_BYTES``), the
    counterpart of the reference's VMEM residency filter, so a tile
    that cannot launch is never measured;
  * persists the winner in a JSON table keyed like a compile cache
    (sorted keys, atomic replace), memoized in memory, at
    ``REPRO_TORCH_TUNE_TABLE`` or else ``~/.cache/repro_torch/
    tune_table.json``. The format is the port's own
    (``TABLE_META["format"]``): a table of the reference's is refused
    as poisoned, never misread.

A tile is ``(bn, S)``: gemm_split's block width (``FWD_BNS``) and the
count of K slices (``SPLIT_LADDER``, deduplicated by the split each one
gives: 8 slices asked of K = 784 are 7 of 128, as 7 are). The kernel's
own heuristic tile (``ff_dense.launch_tile``) is always a candidate. The
backward's split is not swept; it rides along at its default, as the
reference's ``bk`` does.

``ops.ff_dense`` reads the table for CUDA operands only
(``ops.resolve_ff_dense``, memoized per bucket in ``RESOLVED``):
``impl="auto"`` and a forced tunable impl launch the bucket's tuned
tile; a miss, or a poisoned entry (corrupt JSON, a foreign format, a
non-int field, a tile outside ``candidate_tiles``, an unregistered impl),
warns and launches the kernel's default tile, never crashes. CPU
operands never read a table.

One deliberate difference from the reference: on ``cuda`` the plain
version is timed as the baseline (``ref_time_s``) and is never written
as the winner, because nothing on the main path runs the plain version
when a card is present; ``_validated`` treats an entry that names
``"ref"`` for ``cuda`` as poisoned, which means the kernel's default
tile, never the plain version. On the CPU (the tests) the plain version
competes, as in the reference.

Bit-exactness note (also in the table meta): winners are gated on the
1e-4 error, not on bit-exactness. A tuned S changes the order in which
the kernel sums K slices, so a tuned run and an untuned one may differ
in the last bits. The port's bit-exact gates compare two runs under one
table (the executor against the sequential fit) and stay bit-exact;
``impl="ref"`` reads no table.

Timing is injectable (``timer(thunk, label) -> seconds``); by default,
on the card, CUDA events around the step after a warm-up, with L2
flushed and a spin kernel ahead of the step (so the host's enqueue
stays out of the span), the median of ``TIMER_REPEATS``; on the CPU,
the best wall-clock time.

    PYTHONPATH=src python -m repro_torch.kernels.autotune    # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import warnings

import torch

from repro_torch.core.rng import TorchKey
from repro_torch.device import resolve_device
from repro_torch.kernels import ff_dense as kernel, registry
from repro_torch.obs import trace as obs_trace

ERR_GATE = 1e-4

DEFAULT_TABLE_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "tune_table.json")

TABLE_META = {
    "format": "repro-torch-kernel-tune-v1",
    "err_gate": ERR_GATE,
    "note": (
        "Winners are gated on scale-normalized value AND grad error vs "
        "the ref oracle (<= err_gate), not on bit-exactness: a tuned "
        "(bn, S) tile changes the order in which the CUDA kernel sums "
        "its K slices. The executor-vs-sequential bit-exactness gates "
        "compare two runs under one table and stay bit-exact; "
        "impl='ref' reads no table, and on cuda the plain version is "
        "never a winner."),
}

# slice counts asked of _fwd_split; the split each gives is kept once
SPLIT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16)
# the main path's f32 buckets (N = 2000): training M 128 and serving M
# 640, at the first layer's K 784 and the hidden layers' 2000
MAIN_PATH_SHAPES = tuple((M, K, 2000) for M in (128, 640)
                         for K in (784, 2000))
TIMER_REPEATS = 10
L2_FLUSH_BYTES = 128 * 2 ** 20       # over the H100's 50 MB of L2
SPIN_CYCLES = 20_000_000             # ~10 ms: longer than a step's enqueue


def table_path():
    """The table's location: ``REPRO_TORCH_TUNE_TABLE``, else the
    per-user cache default."""
    return os.environ.get("REPRO_TORCH_TUNE_TABLE") or DEFAULT_TABLE_PATH


def _dtype_name(dtype):
    """``float32`` / ``bfloat16`` of a torch dtype (or a name)."""
    return str(dtype).replace("torch.", "")


def key_for(op, M, K, N, dtype, platform, norm):
    """Compile-cache-style table key for one shape bucket (the
    reference's format)."""
    return (f"{op}|M={M}|K={K}|N={N}|dtype={_dtype_name(dtype)}"
            f"|platform={platform}|norm={int(bool(norm))}")


def candidate_tiles(M, K, N, *, norm=False, budget=kernel.SMEM_BUDGET_BYTES,
                    bns=kernel.FWD_BNS):
    """The legal (bn, S) grid for one shape: each block width of ``bns``
    whose ring fits ``budget``, with each distinct split of
    ``SPLIT_LADDER``, and always the kernel's default tile. ``norm``
    changes nothing: the epilogue runs in finish_rows, whose shared
    memory does not depend on the tile."""
    del norm
    default = kernel.launch_tile(M, K, N)[:2]
    out = []
    for bn in bns:
        if kernel.smem_block_bytes(bn) > budget:
            continue
        wants = SPLIT_LADDER + ((default[1],) if bn == default[0] else ())
        splits = {kernel._fwd_split(M, K, N, bn, s)[0] for s in wants}
        out += [(bn, s) for s in sorted(splits)]
    return out


# ---------------------------------------------------------------------------
# Tuning table: JSON persistence + in-memory memoization
# ---------------------------------------------------------------------------

class TuneTable:
    """The persisted winners, keyed by ``key_for``.

    Entry schema: {"impl": str, "time_s": float, "err": float,
    "grad_err": float}, plus, whenever a tile of a tunable impl passed
    the gates, {"bn": int, "splits": int, "cuda_time_s": float} for the
    fastest passing tile, and {"ref_time_s": float} for the plain
    version's time.
    """

    def __init__(self, path=None):
        self.path = path or table_path()
        self.meta = dict(TABLE_META)
        self.entries = {}

    @classmethod
    def open(cls, path=None):
        return cls(path).load()

    def load(self):
        if not os.path.exists(self.path):
            return self
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if not isinstance(raw, dict):
                raise ValueError("not a JSON object")
            fmt = (raw.get("meta") or {}).get("format")
            if fmt != TABLE_META["format"]:
                raise ValueError(f"format {fmt!r} is not "
                                 f"{TABLE_META['format']!r}")
            entries = raw["entries"]
            if not isinstance(entries, dict):
                raise ValueError("'entries' is not an object")
        except (OSError, json.JSONDecodeError, KeyError, ValueError,
                TypeError, AttributeError) as e:
            warnings.warn(
                f"poisoned kernel tuning table at {self.path} ({e}); "
                f"ignoring it and falling back to the default tiles")
            return self
        self.entries = entries
        self.meta = raw["meta"]
        return self

    def save(self):
        """Atomic write with byte-stable key ordering (sort_keys), so a
        re-tune that changes nothing leaves the file bit-identical."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"meta": self.meta, "entries": self.entries}, f,
                      indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)
        invalidate_cache(self.path)
        return self.path

    def get(self, key):
        return self.entries.get(key)

    def put(self, key, entry):
        self.entries[key] = entry

    def __len__(self):
        return len(self.entries)


# path -> TuneTable: one process reads a table file at most once per
# path (STATS counts it); RESOLVED is ops.resolve_ff_dense's memo of
# (impl, tile) per bucket, dropped with the tables
_CACHE = {}
STATS = {"loads": 0, "memo_hits": 0}
RESOLVED = {}


def cached_table():
    path = table_path()
    if path in _CACHE:
        STATS["memo_hits"] += 1
        return _CACHE[path]
    STATS["loads"] += 1
    t = TuneTable.open(path)
    _CACHE[path] = t
    return t


def invalidate_cache(path=None):
    """Drop the in-memory table memo (one path, or all) and every
    memoized resolution."""
    if path is None:
        _CACHE.clear()
    else:
        _CACHE.pop(path, None)
    RESOLVED.clear()


def _validated(entry, key, platform, M, K, N, norm):
    """None (with a warning) unless the entry is shaped like a winner
    that may run on ``platform`` and its tile is a candidate: the
    poisoned-table fallback."""
    try:
        impl = entry["impl"]
        if not isinstance(impl, str):
            raise ValueError("impl is not a string")
        if impl not in registry.ff_dense:
            raise ValueError(f"impl {impl!r} is not registered")
        if platform == "cuda" and impl == "ref":
            raise ValueError("the plain version is never the winner on "
                             "cuda")
        if "bn" in entry or "splits" in entry:
            tile = (entry["bn"], entry["splits"])
            if not all(type(v) is int for v in tile):
                raise ValueError(f"non-int tile {tile!r}")
            if tile not in candidate_tiles(M, K, N, norm=norm):
                raise ValueError(f"tile {tile} is not a candidate at "
                                 f"M={M} K={K} N={N}")
        elif registry.ff_dense.get(impl).tunable:
            raise ValueError(f"tunable winner {impl!r} without a tile")
    except (KeyError, ValueError, TypeError) as e:
        warnings.warn(f"poisoned tuning-table entry {key!r} ({e}); "
                      f"falling back to the default tile")
        return None
    return entry


def lookup(op, M, K, N, dtype, platform, *, norm=False):
    """The validated winning entry for this shape bucket, or None (the
    registry's default impl at its default tile)."""
    key = key_for(op, M, K, N, dtype, platform, norm)
    entry = cached_table().get(key)
    if entry is None:
        return None
    return _validated(entry, key, platform, M, K, N, norm)


def entry_tile(entry):
    """An entry's tuned ``(bn, S)``, or None if it has none (only the
    plain version passed the gates)."""
    if "bn" not in entry:
        return None
    return (entry["bn"], entry["splits"])


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def _tune_data(key, M, K, N, dtype, device):
    """x, w, b in ``dtype`` and f32 cotangents for both outputs (y
    through cy, the raw goodness through cg, so the backward's dg path
    is gated too), drawn on the CPU from ``key``, as the reference's.

    One difference: cy is 0 where the pre-activation ``x @ w + b``
    (float64) lies within ``ERR_GATE * max|x @ w + b|`` of zero. relu's
    gradient jumps there, and two correct forwards that sum in other
    orders put such an entry on either side of zero: the candidate's
    and the oracle's dy then differ by that entry's cy, which moved dx
    by 2e-2 of its scale at (640, 2000, 2000) on an H100. With cy 0 the
    jump is the dg term's 2 y cg, under the gate. The forward values
    there are compared as everywhere."""
    kx, kw, ky, kg = key.split(4)
    x = kx.normal((M, K)).to(dtype)
    w = (kw.normal((K, N)) * K ** -0.5).to(dtype)
    b = torch.full((N,), 0.1, dtype=dtype)
    cy = ky.normal((M, N)) * 0.01
    cg = kg.normal((M,)) * 0.01
    x, w, b, cy, cg = (t.to(device) for t in (x, w, b, cy, cg))
    z = torch.addmm(b.double(), x.double(), w.double()).abs()
    cy = cy.masked_fill(z <= ERR_GATE * z.max(), 0.0)
    return x, w, b, cy, cg


def _step(fn, tile, data, norm):
    """One forward + backward of the reference's tuning loss: (y, g,
    (dx, dw, db))."""
    x, w, b, cy, cg = (t.detach() for t in data)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    kw = {} if tile is None else {"tile": tile}
    with torch.enable_grad():
        y, g = fn(x, w, b, norm=norm, **kw)
        loss = (torch.vdot(y.float().reshape(-1), cy.reshape(-1))
                + torch.vdot(g, cg))
        grads = torch.autograd.grad(loss, (x, w, b))
    return y.detach(), g.detach(), grads


def _scale_err(a, b):
    a = a.detach().float()
    b = b.detach().float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def _candidate_errors(impl_name, tile, data, oracle, *, norm):
    """(value_err, grad_err) of one candidate against the plain version,
    scale-normalized: max over y and g, and over dx, dw and db."""
    y, g, grads = _step(registry.ff_dense.get(impl_name).fn, tile, data,
                        norm)
    y_r, g_r, grads_r = oracle
    err = max(_scale_err(y, y_r), _scale_err(g, g_r))
    grad_err = max(_scale_err(a, r) for a, r in zip(grads, grads_r))
    return err, grad_err


def _cuda_timer(device, repeats=TIMER_REPEATS):
    """Median device seconds of ``thunk()`` over ``repeats`` calls, after
    two warm-up calls; before each call a spin kernel keeps the card
    busy while the host enqueues, and L2 is flushed."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)

    def timer(thunk, label):
        del label
        for _ in range(2):
            thunk()
        times = []
        for _ in range(repeats):
            torch.cuda._sleep(SPIN_CYCLES)
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            thunk()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        return statistics.median(times)
    return timer


def _wall_timer(thunk, label, repeats=2):
    """Best-of-``repeats`` wall clock after one warm-up call (CPU)."""
    del label
    thunk()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        thunk()
        best = min(best, time.perf_counter() - t0)
    return best


def _candidates(M, K, N, norm, max_candidates):
    """(impl, tile) pairs of one bucket: every tile of each tunable impl
    (at most ``max_candidates``, evenly spread, the default tile kept),
    one None-tile candidate for each other impl."""
    out = []
    tunable = registry.ff_dense.tunable_names()
    for name in registry.ff_dense.names():
        if name not in tunable:
            out.append((name, None))
            continue
        grid = candidate_tiles(M, K, N, norm=norm)
        if max_candidates and len(grid) > max_candidates:
            default = kernel.launch_tile(M, K, N)[:2]
            step = len(grid) / max_candidates
            keep = {grid[int(i * step)] for i in range(max_candidates - 1)}
            grid = [t for t in grid if t in keep or t == default]
        out += [(name, tile) for tile in grid]
    return out


def tune_ff_dense(shapes, *, norms=(False, True), dtype=torch.float32,
                  device="cuda", table=None, timer=None, err_gate=ERR_GATE,
                  seed=0, max_candidates=None, save=True, verbose=True,
                  tracer=obs_trace.NOOP):
    """Sweep ``shapes`` (iterable of (M, K, N)) on ``device``, persist
    the winners.

    Returns one row dict per bucket: ``key``, the shape, ``norm``,
    ``winner`` (the entry written, or None), ``default_tile``,
    ``measured`` (each passing candidate's impl, tile, time and errors),
    ``n_candidates``, ``n_rejected`` and ``rejected``.
    ``timer(thunk, label) -> s`` is injectable; ``max_candidates``
    bounds the tile grid per bucket. ``save=True`` writes the table and
    drops the memos, so later lookups see the new winners. ``tracer=``
    (an ``obs.trace`` tracer) records one ``tune:candidate`` span per
    measured candidate and a ``tune:reject`` event per gate breach.
    """
    dev = resolve_device(device)
    platform = dev.type
    if table is None:
        table = TuneTable.open()
    if timer is None:
        timer = _cuda_timer(dev) if platform == "cuda" else _wall_timer
    ref_fn = registry.ff_dense.get("ref").fn
    rows = []
    root = TorchKey(seed)
    for si, (M, K, N) in enumerate(shapes):
        for norm in norms:
            key = key_for("ff_dense", M, K, N, dtype, platform, norm)
            data = _tune_data(root.fold_in(2 * si + int(norm)), M, K, N,
                              dtype, dev)
            oracle = _step(ref_fn, None, data, norm)
            cands = _candidates(M, K, N, norm, max_candidates)
            measured, rejected = [], []
            for name, tile in cands:
                label = f"{key}|{name}" + (
                    f"|bn={tile[0]}|splits={tile[1]}" if tile else "")
                try:
                    err, grad_err = _candidate_errors(name, tile, data,
                                                      oracle, norm=norm)
                except (RuntimeError, ValueError, TypeError) as e:
                    # an impl that cannot run here (the CUDA kernel on a
                    # CPU tensor, a launch the card refuses)
                    rejected.append({"impl": name, "tile": tile,
                                     "reason": f"raised {e!r}"})
                    if tracer.enabled:
                        tracer.event("tune:reject", key=key, impl=name,
                                     reason="raised")
                    continue
                if err > err_gate or grad_err > err_gate:
                    rejected.append({
                        "impl": name, "tile": tile,
                        "reason": (f"oracle error breach: err={err:.2e} "
                                   f"grad_err={grad_err:.2e} > "
                                   f"{err_gate:.0e}")})
                    if tracer.enabled:
                        tracer.event("tune:reject", key=key, impl=name,
                                     reason="oracle_error", err=err,
                                     grad_err=grad_err)
                    continue
                fn = registry.ff_dense.get(name).fn
                t0_m = tracer.now()
                t = float(timer(lambda: _step(fn, tile, data, norm), label))
                if tracer.enabled:
                    tracer.add_span(
                        "tune:candidate", t0_m, key=key, impl=name,
                        bn=tile[0] if tile else None,
                        splits=tile[1] if tile else None, time_s=t)
                measured.append({"impl": name, "tile": tile, "time_s": t,
                                 "err": err, "grad_err": grad_err})
            row = {"key": key, "M": M, "K": K, "N": N, "norm": norm,
                   "default_tile": kernel.launch_tile(M, K, N)[:2],
                   "measured": measured, "n_candidates": len(cands),
                   "n_rejected": len(rejected), "rejected": rejected}
            rows.append(row)
            eligible = [m for m in measured
                        if not (platform == "cuda" and m["impl"] == "ref")]
            if not eligible:
                warnings.warn(f"no candidate passed the {err_gate:.0e} "
                              f"oracle gate for {key}; bucket left "
                              f"untuned")
                row["winner"] = None
                continue
            best = min(eligible, key=lambda m: m["time_s"])
            entry = {"impl": best["impl"], "time_s": best["time_s"],
                     "err": best["err"], "grad_err": best["grad_err"]}
            tiled = [m for m in measured if m["tile"] is not None]
            if tiled:
                bt = min(tiled, key=lambda m: m["time_s"])
                entry["bn"], entry["splits"] = bt["tile"]
                entry["cuda_time_s"] = bt["time_s"]
            ref_m = [m for m in measured if m["impl"] == "ref"]
            if ref_m:
                entry["ref_time_s"] = ref_m[0]["time_s"]
            table.put(key, entry)
            row["winner"] = dict(entry)
            if verbose:
                tile = (f" bn={entry['bn']} S={entry['splits']}"
                        if "bn" in entry else "")
                print(f"  {key}: winner={entry['impl']}{tile} "
                      f"t={entry['time_s']:.4g}s err={entry['err']:.1e} "
                      f"grad_err={entry['grad_err']:.1e} "
                      f"({len(measured)} passed, {len(rejected)} "
                      f"rejected)")
    if save:
        path = table.save()
        if verbose:
            print(f"  tuning table: {len(table)} entries -> {path}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Tune ff_dense's (bn, S) tile on the card and write "
                    "the table that ops.ff_dense(impl='auto') reads "
                    "(REPRO_TORCH_TUNE_TABLE, else " + DEFAULT_TABLE_PATH
                    + ").")
    ap.add_argument("--shapes", nargs="+", default=None, metavar="M,K,N",
                    help="buckets to tune (default: the main path's "
                         "f32 buckets, M 128 / 640, K 784 / 2000, "
                         "N 2000)")
    ap.add_argument("--norms", nargs="+", type=int, default=[0, 1],
                    choices=[0, 1])
    args = ap.parse_args(argv)
    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes]
              if args.shapes else MAIN_PATH_SHAPES)
    return tune_ff_dense(shapes, norms=[bool(n) for n in args.norms])


if __name__ == "__main__":
    main()
