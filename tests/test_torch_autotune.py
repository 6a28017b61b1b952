"""The port's ff_dense autotuner (``repro_torch.kernels.autotune``) and the
table behind ``ops.ff_dense(impl="auto")``, mirroring the reference's
``tests/test_autotune.py`` where it applies: registry round trip and
``tunable_names``; ``key_for`` and ``_scale_err`` equal to the
reference's on the same inputs; the (bn, S) candidate grid, stated
exactly, with the kernel's default tile in it and the shared-memory
filter; byte-stable saves and re-tunes, the memo; a deterministic winner
under a seeded fake timer; rejection of a candidate over the 1e-4 oracle
gate; the nothing-passed warning; ``ops.resolve_ff_dense`` steering
``"auto"`` and a forced ``"cuda"`` to the tuned tile on ``cuda`` and
reading no table on the CPU; the poisoned-table and poisoned-entry
fallbacks; the table meta's bit-exactness note.

The tests run on CPU tensors: a tunable CPU test impl stands in for the
CUDA kernel in the sweep (the kernel's impl raises on CPU tensors, and
the tuner records it as rejected). Each test gets an empty table path of
its own.
"""
import json
import os
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune, ff_dense as kernel, ff_dense_vjp
from repro_torch.kernels import ops, ref, registry
from repro_torch.obs import trace as obs_trace


@pytest.fixture(autouse=True)
def _isolated_table(tmp_path, monkeypatch):
    """Each test's own empty table path, and empty memos around it."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE",
                       str(tmp_path / "tune_table.json"))
    autotune.invalidate_cache()
    yield
    autotune.invalidate_cache()


@pytest.fixture
def tiletest():
    """A tunable CPU impl (the plain version) that records the tiles it
    was called with."""
    seen = []

    def fn(x, w, b, *, norm, tile=None):
        seen.append(tile)
        return ops.ff_dense(x, w, b, impl="ref", norm=norm)

    registry.ff_dense.register("tiletest", fn, tunable=True)
    try:
        yield seen
    finally:
        registry.ff_dense.unregister("tiletest")


def _seeded_timer(seed):
    """Deterministic fake timer: a time per label from a seeded hash;
    never calls the thunk."""
    def timer(thunk, label):
        del thunk
        return (zlib.crc32(f"{seed}|{label}".encode()) % 10_000 + 1) * 1e-6
    return timer


def _fake_timer(times):
    def timer(thunk, label):
        del thunk
        for frag, t in times.items():
            if frag in label:
                return t
        return 1.0
    return timer


SHAPE = (16, 64, 128)


def _tune(timer, shapes=(SHAPE,), norms=(False,), **kw):
    return autotune.tune_ff_dense(list(shapes), norms=norms, device="cpu",
                                  timer=timer, verbose=False, **kw)


def _put(key, entry):
    t = autotune.TuneTable.open()
    t.put(key, entry)
    t.save()


def _cuda_key(M, K, N, norm=False):
    return autotune.key_for("ff_dense", M, K, N, torch.float32, "cuda",
                            norm)


# ---------------------------------------------------------------------------
# Registry, keys, errors, tiles
# ---------------------------------------------------------------------------

def test_registry_round_trip_and_tunable_names(tiletest):
    for reg in (registry.ff_dense, registry.flash_attention,
                registry.mamba2_ssd):
        assert set(reg.names()) >= {"cuda", "ref"}
        assert reg.choices()[0] == "auto"
        for name in reg.names():
            assert reg.get(name).name == name and name in reg
    assert registry.ff_dense.tunable_names() == ("cuda", "tiletest")
    assert registry.flash_attention.tunable_names() == ()
    assert registry.mamba2_ssd.tunable_names() == ()
    registry.ff_dense.unregister("tiletest")
    assert "tiletest" not in registry.ff_dense
    assert "tiletest" not in registry.ff_dense.choices()


def test_custom_impl_reachable_through_ops_on_cpu(tiletest):
    x, w, b = torch.randn(8, 16), torch.randn(16, 32) * 0.1, torch.zeros(32)
    y, g = ops.ff_dense(x, w, b, impl="tiletest")
    yr, gr = ref.ff_dense_ref(x, w, b)
    assert torch.equal(y, yr) and torch.equal(g, gr)
    assert tiletest == [None]           # the CPU reads no table: no tile


@pytest.mark.parametrize("M,K,N", [(64, 128, 256), (640, 784, 2000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("norm", [False, True])
def test_key_for_equals_the_reference(M, K, N, dtype, platform, norm):
    got = autotune.key_for("ff_dense", M, K, N, getattr(torch, dtype),
                           platform, norm)
    want = jat.key_for("ff_dense", M, K, N, getattr(jnp, dtype), platform,
                       norm)
    assert got == want


def test_scale_err_equals_the_reference():
    rng = np.random.default_rng(0)
    for shape in [(7,), (16, 33), (4, 5, 6)]:
        a = rng.standard_normal(shape).astype(np.float32)
        b = (a + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
        got = autotune._scale_err(torch.from_numpy(a), torch.from_numpy(b))
        assert got == jat._scale_err(a, b)
    z = np.zeros((3, 3), np.float32)
    assert autotune._scale_err(torch.from_numpy(z), torch.from_numpy(z)) \
        == jat._scale_err(z, z) == 0.0


def test_candidate_tiles_grid_stated_exactly():
    at_2000 = [(bn, s) for bn in (64, 128) for s in (1, 2, 3, 4, 6, 8, 11,
                                                     16)]
    at_784 = [(bn, s) for bn in (64, 128) for s in (1, 2, 3, 4, 5, 7, 9,
                                                    13)]
    assert autotune.candidate_tiles(128, 2000, 2000) == at_2000
    assert autotune.candidate_tiles(640, 784, 2000) == at_784
    # the kernel's own tile is always a candidate
    for shape in [(128, 2000, 2000), (640, 784, 2000), (128, 784, 2000),
                  (640, 2000, 2000), (100, 333, 257), (16, 64, 64)]:
        bn, S, _ = kernel.launch_tile(*shape)
        assert (bn, S) in autotune.candidate_tiles(*shape, norm=True)
    assert kernel.launch_tile(128, 2000, 2000)[:2] == (64, 8)
    assert kernel.launch_tile(640, 784, 2000)[:2] == (128, 3)


def test_candidate_tiles_drop_tiles_over_the_shared_memory_budget():
    assert kernel.SMEM_BUDGET_BYTES == 232_448
    assert kernel.smem_block_bytes(64) == 82_944
    assert kernel.smem_block_bytes(128) == 107_520
    assert kernel.smem_block_bytes(512) == 254_976 > kernel.SMEM_BUDGET_BYTES
    grid = autotune.candidate_tiles(128, 2000, 2000, bns=(64, 128, 512))
    assert grid == autotune.candidate_tiles(128, 2000, 2000)
    assert {bn for bn, _ in grid} == {64, 128}
    small = autotune.candidate_tiles(128, 2000, 2000, budget=100_000)
    assert {bn for bn, _ in small} == {64}


@pytest.mark.parametrize("K", [32, 100, 333, 784, 2000, 4096])
def test_split_override_is_legal_and_a_fixed_point(K):
    for splits in range(1, 40):
        S, L = kernel._fwd_split(128, K, 2000, 64, splits)
        assert L % kernel.FWD_BK == 0 and 1 <= S <= splits
        assert (S - 1) * L < K <= S * L          # every slice non-empty
        assert kernel._fwd_split(128, K, 2000, 64, S) == (S, L)
    # no override: exactly the heuristics' split, unchanged
    assert kernel._fwd_split(128, 2000, 2000) == (8, 256)
    assert kernel._fwd_split(128, 784, 2000) == (7, 128)
    assert kernel._fwd_split(640, 2000, 2000) == (3, 672)
    with pytest.raises(ValueError, match="block widths"):
        kernel.launch_tile(128, 784, 2000, (96, 2))
    with pytest.raises(ValueError, match="split count"):
        kernel.launch_tile(128, 784, 2000, (64, 0))


@pytest.mark.parametrize("norm", [False, True])
def test_autograd_functions_carry_a_tile_on_cpu(norm):
    """On CPU tensors the Functions run the plain version whatever the
    tile; the tile argument gets no gradient."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 32, generator=g, requires_grad=True)
    w = (torch.randn(32, 16, generator=g) * 0.2).requires_grad_()
    b = torch.zeros(16, requires_grad=True)
    fn = ff_dense_vjp.ff_dense_norm_vjp if norm else ff_dense_vjp.ff_dense_vjp
    y, gd = fn(x, w, b, (64, 2))
    yr, gr = kernel.ff_dense_plain(x, w, b, norm=norm)
    assert torch.allclose(y, yr) and torch.allclose(gd, gr)
    got = torch.autograd.grad((y.sum() + gd.sum()), (x, w, b))
    want = torch.autograd.grad((yr.sum() + gr.sum()), (x, w, b))
    for a, r in zip(got, want):
        assert torch.allclose(a, r, atol=1e-6)


# ---------------------------------------------------------------------------
# Persistence and memo
# ---------------------------------------------------------------------------

def test_table_round_trip_and_memo_hit(tiletest):
    rows = _tune(_fake_timer({"ref": 0.5, "tiletest|bn=64|splits=1": 0.1}))
    assert rows[0]["winner"]["impl"] == "tiletest"
    path = autotune.table_path()
    assert os.path.exists(path)
    fresh = autotune.TuneTable.open(path)
    assert fresh.entries == {r["key"]: r["winner"] for r in rows}
    autotune.invalidate_cache()
    loads0, hits0 = autotune.STATS["loads"], autotune.STATS["memo_hits"]
    first = autotune.lookup("ff_dense", *SHAPE, torch.float32, "cpu")
    again = autotune.lookup("ff_dense", *SHAPE, torch.float32, "cpu")
    assert first == again == fresh.entries[rows[0]["key"]]
    assert autotune.STATS["loads"] == loads0 + 1
    assert autotune.STATS["memo_hits"] == hits0 + 1


def test_save_is_byte_stable_and_retune_leaves_the_file_identical(
        tmp_path, tiletest):
    e1 = {"impl": "ref", "time_s": 0.5, "err": 0.0, "grad_err": 0.0}
    e2 = {"impl": "cuda", "bn": 64, "splits": 8, "time_s": 0.1,
          "err": 1e-6, "grad_err": 1e-6}
    a = autotune.TuneTable(str(tmp_path / "a.json"))
    a.put("k1", dict(e1))
    a.put("k2", dict(e2))
    b = autotune.TuneTable(str(tmp_path / "b.json"))
    b.put("k2", dict(e2))
    b.put("k1", dict(e1))
    a.save()
    b.save()
    with open(a.path, "rb") as f1, open(b.path, "rb") as f2:
        assert f1.read() == f2.read()
    timer = _seeded_timer(3)
    _tune(timer)
    with open(autotune.table_path(), "rb") as f:
        before = f.read()
    _tune(timer)
    with open(autotune.table_path(), "rb") as f:
        assert f.read() == before


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def test_deterministic_winner_under_a_seeded_fake_timer(tiletest):
    timer = _seeded_timer(7)
    rows_a = _tune(timer, norms=(False, True))
    autotune.invalidate_cache()
    rows_b = _tune(timer, norms=(False, True))
    assert [r["winner"] for r in rows_a] == [r["winner"] for r in rows_b]
    grid = autotune.candidate_tiles(*SHAPE)
    for row in rows_a:
        key = row["key"]
        want = {("ref", None): timer(None, f"{key}|ref")}
        want.update({("tiletest", t): timer(
            None, f"{key}|tiletest|bn={t[0]}|splits={t[1]}") for t in grid})
        w = row["winner"]
        assert w["impl"] == min(want, key=want.get)[0]
        best_tile = min(grid, key=lambda t: want[("tiletest", t)])
        assert (w["bn"], w["splits"]) == best_tile
        assert w["ref_time_s"] == want[("ref", None)]
        assert w["err"] <= autotune.ERR_GATE
        assert w["grad_err"] <= autotune.ERR_GATE
        # every tile was measured through the impl, the kernel's impl
        # raised on CPU tensors at each of them
        assert len(row["measured"]) == len(grid) + 1
        assert row["n_rejected"] == len(grid)
        assert all(r["impl"] == "cuda" and r["reason"].startswith("raised")
                   for r in row["rejected"])
    assert set(tiletest) >= set(grid)


def test_candidate_rejected_on_oracle_error_breach(monkeypatch, tiletest):
    bad = (64, 1)
    real = autotune._candidate_errors

    def rigged(impl_name, tile, data, oracle, *, norm):
        if impl_name == "tiletest" and tile == bad:
            return 1.0, 1.0
        return real(impl_name, tile, data, oracle, norm=norm)

    monkeypatch.setattr(autotune, "_candidate_errors", rigged)
    tracer = obs_trace.Tracer()
    rows = _tune(_fake_timer({"tiletest|bn=64|splits=1": 1e-9,
                              "ref": 0.2}), tracer=tracer)
    w = rows[0]["winner"]
    assert w is not None and (w["bn"], w["splits"]) != bad
    assert any(r["tile"] == bad and "oracle error breach" in r["reason"]
               for r in rows[0]["rejected"])
    # one tune:candidate span per measured candidate, one tune:reject
    # event per rejection (the breach and the kernel's raises on CPU)
    spans = [sp for sp in tracer.spans if sp.name == "tune:candidate"]
    assert len(spans) == len(rows[0]["measured"])
    reasons = [e.attrs["reason"] for e in tracer.events
               if e.name == "tune:reject"]
    assert len(reasons) == rows[0]["n_rejected"]
    assert reasons.count("oracle_error") == 1


def test_max_candidates_bounds_the_grid_and_keeps_the_default(tiletest):
    rows = _tune(_seeded_timer(5), max_candidates=3, save=False)
    tiles = [m["tile"] for m in rows[0]["measured"] if m["tile"]]
    assert len(tiles) <= 3 and len(set(tiles)) == len(tiles)
    assert tuple(rows[0]["default_tile"]) in tiles
    assert set(tiles) <= set(autotune.candidate_tiles(*SHAPE))


def test_untuned_bucket_warns_when_nothing_passes(monkeypatch):
    monkeypatch.setattr(autotune, "_candidate_errors",
                        lambda *a, **k: (1.0, 1.0))
    with pytest.warns(UserWarning, match="no candidate passed"):
        rows = _tune(_seeded_timer(0))
    assert rows[0]["winner"] is None
    assert len(autotune.TuneTable.open(autotune.table_path())) == 0


def test_default_cpu_timer_tunes_the_plain_version():
    rows = autotune.tune_ff_dense([(8, 32, 64)], norms=(True,),
                                  device="cpu", save=False, verbose=False)
    w = rows[0]["winner"]
    assert w["impl"] == "ref" and "bn" not in w and w["time_s"] > 0
    assert w["err"] == w["grad_err"] == 0.0
    assert rows[0]["default_tile"] == kernel.launch_tile(8, 32, 64)[:2]


def test_table_meta_documents_the_bit_exactness_policy(tiletest):
    _tune(_seeded_timer(1))
    with open(autotune.table_path()) as f:
        raw = json.load(f)
    note = raw["meta"]["note"]
    assert "bit-exactness" in note and "ref" in note
    assert raw["meta"]["err_gate"] == autotune.ERR_GATE
    assert raw["meta"]["format"] == "repro-torch-kernel-tune-v1"


# ---------------------------------------------------------------------------
# ops: the table steers the CUDA kernel's tile; the CPU reads no table
# ---------------------------------------------------------------------------

def test_resolve_steers_auto_and_forced_cuda_to_the_tuned_tile():
    M, K, N = 128, 784, 2000
    tile = (128, 13)
    assert tile != kernel.launch_tile(M, K, N)[:2]
    _put(_cuda_key(M, K, N), {"impl": "cuda", "bn": 128, "splits": 13,
                              "time_s": 1e-4, "err": 0.0, "grad_err": 0.0,
                              "cuda_time_s": 1e-4, "ref_time_s": 2e-4})
    f32 = torch.float32
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", False, "auto") \
        == ("cuda", tile)
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", False, "cuda") \
        == ("cuda", tile)
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", False, "ref") \
        == ("ref", None)
    # another bucket (norm on, another M) misses: the default tile
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", True, "auto") \
        == ("cuda", None)
    assert ops.resolve_ff_dense(64, K, N, f32, "cuda", False, "cuda") \
        == ("cuda", None)
    # memoized per bucket: a second call reads nothing
    loads, hits = autotune.STATS["loads"], autotune.STATS["memo_hits"]
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", False, "auto") \
        == ("cuda", tile)
    assert (autotune.STATS["loads"], autotune.STATS["memo_hits"]) \
        == (loads, hits)
    # a re-saved table drops the memo
    _put(_cuda_key(M, K, N), {"impl": "cuda", "bn": 64, "splits": 2,
                              "time_s": 1e-4, "err": 0.0, "grad_err": 0.0})
    assert ops.resolve_ff_dense(M, K, N, f32, "cuda", False, "auto") \
        == ("cuda", (64, 2))


def test_cpu_reads_no_table(tiletest):
    """A cpu-platform winner naming another impl, and a corrupt file, are
    both ignored for CPU tensors: no load, no warning, the plain
    version."""
    x, w, b = torch.randn(8, 16), torch.randn(16, 32) * 0.1, torch.zeros(32)
    _put(autotune.key_for("ff_dense", 8, 16, 32, torch.float32, "cpu",
                          False),
         {"impl": "tiletest", "bn": 64, "splits": 1, "time_s": 0.1,
          "err": 0.0, "grad_err": 0.0})
    loads = autotune.STATS["loads"]
    y, _ = ops.ff_dense(x, w, b)
    assert torch.equal(y, ref.ff_dense_ref(x, w, b)[0]) and tiletest == []
    assert ops.resolve_ff_dense(8, 16, 32, torch.float32, "cpu", False,
                                "auto") == ("ref", None)
    with open(autotune.table_path(), "w") as f:
        f.write("{ not json")
    autotune.invalidate_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ops.ff_dense(x, w, b)
    assert autotune.STATS["loads"] == loads


def _auto_on_cuda():
    return ops.resolve_ff_dense(128, 784, 2000, torch.float32, "cuda",
                                False, "auto")


@pytest.mark.parametrize("text", [
    "{ not json at all",
    json.dumps({"meta": dict(jat.TABLE_META), "entries": {}}),
    json.dumps({"meta": dict(autotune.TABLE_META), "entries": []}),
    json.dumps([1, 2, 3]),
])
def test_poisoned_table_warns_and_gives_the_default_tile(text):
    """A corrupt file, a table of the reference's format, or a malformed
    one: warn, then the kernel at its default tile."""
    path = autotune.table_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    with pytest.warns(UserWarning, match="poisoned kernel tuning table"):
        assert _auto_on_cuda() == ("cuda", None)


@pytest.mark.parametrize("entry", [
    {"impl": "cuda", "bn": "sixty-four", "splits": 7},   # non-int field
    {"impl": "cuda", "bn": 64, "splits": 7.0},           # non-int field
    {"impl": "cuda", "bn": 64, "splits": True},          # a bool
    {"impl": "cuda", "bn": 96, "splits": 7},             # not a candidate
    {"impl": "cuda", "bn": 64, "splits": 6},             # gives 5 slices
    {"impl": "cuda"},                                    # tunable, no tile
    {"impl": "ref"},                                     # plain on cuda
    {"impl": "ref", "bn": 64, "splits": 7},              # plain on cuda
    {"impl": "not_registered"},                          # unknown impl
    {"impl": 3},                                         # not a string
    {"time_s": 0.1},                                     # no impl at all
    ["cuda", 64, 7],                                     # not an object
])
def test_poisoned_entry_warns_and_gives_the_default_tile(entry):
    _put(_cuda_key(128, 784, 2000), entry)
    with pytest.warns(UserWarning, match="poisoned tuning-table entry"):
        assert _auto_on_cuda() == ("cuda", None)
    # forced impl="cuda" reads the same entry and also gets the default
    autotune.invalidate_cache()
    with pytest.warns(UserWarning, match="poisoned tuning-table entry"):
        assert ops.resolve_ff_dense(128, 784, 2000, torch.float32, "cuda",
                                    False, "cuda") == ("cuda", None)
