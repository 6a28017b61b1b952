"""The traced run: a ``torch.profiler`` trace of the window, the shapes of
the hand-written kernels' calls, and what the readers take from them.

The profiler records the device's kernels, copies and sets (CUPTI) and
the host's operators and the drivers' task annotations, on one clock.
The shapes of each ``ff_dense``, ``ff_dense_bwd`` and ``flash_attention``
call are noted by wrapping the program's kernel entry points for the
traced window only (a list append per call); the device time of those
calls is the summed time of the kernels of their names in the trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time

import torch

# kernel entry point -> the device kernels' function names in the trace
KERNELS = {
    "ff_dense": ("gemm_split", "finish_rows"),
    "ff_dense_bwd": ("grad_x", "sum_slices", "grad_w"),
    "flash_attention": ("flash_fwd", "flash_fwd_tc"),
}
WINDOW = "portbench.window"


def short_name(name):
    """A device kernel's function name: no return type, template
    arguments, namespace or parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name.split("::")[-1].strip()


@contextlib.contextmanager
def shapes_noted(calls):
    """Wraps the program's kernel entry points so that each call notes
    its shapes in ``calls[entry]``."""
    from repro_torch.kernels import ff_dense, ff_dense_vjp
    from repro_torch.kernels import flash_attention as fa

    orig = (ff_dense.ff_dense, ff_dense_vjp.ff_dense_bwd, fa.flash_attention)

    def fwd(x, w, b, *, norm=False, tile=None):
        calls.setdefault("ff_dense", []).append(
            (x.shape[0], x.shape[1], w.shape[1], bool(norm),
             x.element_size()))
        return orig[0](x, w, b, norm=norm, tile=tile)

    def bwd(x, w, y, dy_out, dg):
        calls.setdefault("ff_dense_bwd", []).append(
            (x.shape[0], x.shape[1], w.shape[1], x.element_size()))
        return orig[1](x, w, y, dy_out, dg)

    def attn(q, k, v, *, causal=True, window=None, **kw):
        calls.setdefault("flash_attention", []).append(
            (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
             q.shape[3], bool(causal), q.element_size(), window))
        return orig[2](q, k, v, causal=causal, window=window, **kw)

    ff_dense.ff_dense, ff_dense_vjp.ff_dense_bwd, fa.flash_attention = \
        fwd, bwd, attn
    try:
        yield calls
    finally:
        ff_dense.ff_dense, ff_dense_vjp.ff_dense_bwd, fa.flash_attention = \
            orig


def profile():
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof):
    """The chrome trace's complete events (written to a temporary file
    under ``TMPDIR`` and read back)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    return [e for e in raw.get("traceEvents", []) if e.get("ph") == "X"]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(evs, n_devices):
    """What the readers take from a trace: the window, the device's busy
    seconds (the union of its kernels, copies and sets, averaged over the
    devices), kernel seconds by name, the longest device operations and
    the longest idle gaps with what the host ran in them."""
    win = [e for e in evs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    by_dev, by_name = {}, {}
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        by_dev.setdefault(dev, []).append((a, b))
        name = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy = {d: _merge(v) for d, v in by_dev.items()}
    busy_s = sum(sum(b - a for a, b in v) for v in busy.values()) * 1e-6
    busy_s /= max(n_devices, 1)
    gaps = []
    for v in busy.values():
        edges = [w0] + [x for ab in v for x in ab] + [w1]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in evs if e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != WINDOW]
    named = [[_host_name(host, a, b), (b - a) * 1e-6] for a, b in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernel_s": by_name,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": named}}


def _host_name(host, a, b):
    """The task annotation over a gap, and the host operator that
    overlaps it most."""
    task, op, best = "", "", 0.0
    for e in host:
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        over = min(t, b) - max(s, a)
        if e["cat"] == "user_annotation" and s <= a and t >= b:
            task = e["name"]
        elif e["cat"] == "cpu_op" and over > best:
            op, best = e["name"], over
    return f"{task}/{op}" if task else op or "host"


class task_span:
    """A task record on the host's clock, ``(name, start, end)`` appended
    to ``spans`` after the work inside (which ends in a synchronize), and
    the same span marked in a profiler trace."""

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t0, time.perf_counter()))
        self.rf.__exit__(*exc)
