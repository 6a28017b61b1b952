"""Ring attention of the port (``models.ring_attention``) on 4 gloo
ranks, against the reference.

The three cases of ``tests/test_ring_attention.py``, drawn from numpy
seeds, go through the port's ``ring_attention`` over a (seq=4) mesh of 4
spawned gloo processes (``torch_gloo_ranks``, once for the module; the
first case again over (data=2, seq=2) with the batch split), and
through the reference's own ``ring_attention`` in a subprocess with 4
fake host devices, as that test runs it. Every rank's result is held to
2e-5 of the reference's ``kernels/ref.flash_attention_ref``, computed
here, and of the reference's ring. The per-rank body on one rank (no
group) is the plain attention.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.models import attention, ring_attention as tring

import torch_gloo_ranks as gr

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-5
# (B, S, H, KV, hd, causal): tests/test_ring_attention.py's cases
CASES = [(2, 128, 4, 2, 32, True), (1, 64, 4, 4, 16, False),
         (2, 256, 8, 1, 32, True)]

REF_RING = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.models.ring_attention import ring_attention
    data = np.load(os.path.join(sys.argv[1], "ring_inputs.npz"))
    mesh = jax.make_mesh((4,), ("seq",))
    out = {}
    for i in range(%d):
        q, k, v = (data[f"{t}{i}"] for t in "qkv")
        with mesh:
            out[f"case{i}"] = np.asarray(ring_attention(
                q, k, v, mesh=mesh, axis="seq",
                causal=bool(data[f"causal{i}"])))
    np.savez(os.path.join(sys.argv[1], "ref_ring.npz"), **out)
""" % len(CASES))


def _inputs(i):
    B, S, H, KV, hd, causal = CASES[i]
    rng = np.random.default_rng(100 + i)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return draw(B, S, H, hd), draw(B, S, KV, hd), draw(B, S, KV, hd), causal


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 ranks' results, the reference ring's), both subprocesses
    run side by side."""
    out = tmp_path_factory.mktemp("ring_ranks")
    arrays = {}
    for i in range(len(CASES)):
        q, k, v, causal = _inputs(i)
        arrays.update({f"q{i}": q, f"k{i}": k, f"v{i}": v,
                       f"causal{i}": np.array(causal)})
    np.savez(out / "ring_inputs.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in ([sys.executable, "-m", "torch_gloo_ranks", "ring",
                          str(out)],
                         [sys.executable, "-c", REF_RING, str(out)])]
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, so[-4000:] + se[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(gr.WORLD)]
    assert all(r["leaked"] == [] for r in ranks)     # no rank loaded jax
    return ranks, dict(np.load(out / "ref_ring.npz"))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"B{b}-S{s}-H{h}/{kv}-hd{d}-causal{c}"
                              for b, s, h, kv, d, c in CASES])
def test_ring_attention_on_four_ranks_matches_the_reference(runs, i):
    ranks, ref_ring = runs
    q, k, v, causal = _inputs(i)
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert float(np.abs(ref_ring[f"case{i}"] - oracle).max()) < TOL
    for res in ranks:
        got = res[f"case{i}"].numpy()
        assert got.shape == q.shape
        assert float(np.abs(got - oracle).max()) < TOL
        assert float(np.abs(got - ref_ring[f"case{i}"]).max()) < TOL


def test_ring_attention_with_the_batch_split_matches(runs):
    ranks, _ = runs
    q, k, v, causal = _inputs(0)
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    for res in ranks:
        assert float(np.abs(res["batch_split"].numpy() - oracle).max()) < TOL


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_body_on_one_rank_is_the_plain_attention(i):
    q, k, v, causal = (torch.tensor(a) if isinstance(a, np.ndarray) else a
                       for a in _inputs(i))
    got = tring.ring_attention_local(q, k, v, group=None, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    assert float((got - want).abs().max()) < TOL
    # the size-1 mesh path: no group, nothing sent
    mesh = type("M", (), {"shape": {"seq": 1}})()
    assert torch.equal(tring.ring_attention(q, k, v, mesh=mesh, axis="seq",
                                            causal=causal), got)
    # the merge it shares with chunked_attention's offset path
    shifted = attention.chunked_attention(q, k, v, causal=causal,
                                          q_offset=5, k_offset=5)
    assert float((shifted - want).abs().max()) < TOL
