"""The pod path of the port (``core.pff_pod``, ``api.fit(backend="pod")``,
the expert-parallel MoE) on the CPU.

* Against the reference's math: the reference's own ``shard_map`` step
  fails on this tree's jax (``ROADMAP.md`` §3), so the anchor is a JAX
  host loop composed of the reference's ``blocks.block_apply``,
  ``ff.mean_goodness``, ``ff.ff_loss_masked``, ``ff.corrupt_tokens`` and
  ``optim.adam_update`` over every (stage, data shard), with a register
  list and each unit's shard grads averaged before its Adam step. It is
  held against the port's step at stages 1 x data 1 with no process
  group, on the reference's draws (``JaxKey``), and against every rank
  of the 4-rank layouts, at the repo's leaf rule.
* Across ranks: 4 gloo processes (``torch_gloo_ranks``, spawned once for
  the module) run the (4 stages x 1 data) and (2 x 2) layouts, whose
  every rank's rows and loss must also be bit-identical to the
  in-process oracle loop ``torch_gloo_ranks.pod_oracle``, each rank
  holding its own rows only; ``api.fit(backend="pod", num_nodes=4)`` in
  the same ranks; and the MoE over (data 2 x model 2), fsdp on data,
  each rank's output within 1e-5 of ``NO_DIST`` on its token shard (its
  grads, and the LM steps under a ``Dist``, are
  ``tests/test_torch_dist_train.py``'s).
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget
from repro.core import ff as jff
from repro.models import blocks as jblocks, transformer as jtr
from repro.models.mlp import NO_DIST as J_NO_DIST
from repro_torch import api as tapi, data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 tree_leaves)
from repro_torch.core import ff as tff, pff_lm, pff_pod
from repro_torch.core.rng import TorchKey
from repro_torch.models import blocks as tblocks, mlp as tmlp, transformer

import torch_gloo_ranks as gr
from test_torch_lm_exec import deterministic  # noqa: F401
from test_torch_lm_train import LOSS_TOL, _assert_params_close, _rel
from test_torch_lm_train import one_thread  # noqa: F401
from test_torch_train import JaxKey

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The pod suite's results, one dict per rank (4 gloo processes)."""
    out = tmp_path_factory.mktemp("pod_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, "-m", "torch_gloo_ranks", "pod",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    res = [torch.load(out / f"rank{r}.pt") for r in range(gr.WORLD)]
    assert all(r["leaked"] == [] for r in res)      # no rank loaded jax
    return res


@pytest.fixture(scope="module")
def oracles():
    torch.use_deterministic_algorithms(True)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = gr.pod_config()
        out = {}
        for key, (stages, n_data), steps in (
                *((lay, lay, gr.POD_STEPS) for lay in gr.POD_LAYOUTS),
                ("fit", (gr.WORLD, 1), gr.FIT_STEPS)):
            params = transformer.init(torch.Generator().manual_seed(0), cfg)
            losses = gr.pod_oracle(
                cfg, params, tdata.lm_batches(cfg.vocab, gr.POD_BATCH,
                                              gr.POD_SEQ, steps),
                stages=stages, n_data=n_data, lr=gr.POD_LR)
            out[key] = params, losses
    finally:
        torch.set_num_threads(prev)
        torch.use_deterministic_algorithms(False)
    return out


@pytest.mark.parametrize("layout", gr.POD_LAYOUTS,
                         ids=[f"{s}x{d}" for s, d in gr.POD_LAYOUTS])
def test_pod_layouts_are_bit_identical_to_the_oracle(ranks, oracles,
                                                     layout):
    stages, n_data = layout
    want_params, want_losses = oracles[layout]
    per = gr.POD_BLOCKS // stages
    seen = set()
    for res in ranks:
        got = res[f"pod{stages}x{n_data}"]
        s = got["stage"]
        seen.add((s, got["data"]))
        rows = [t[s * per:(s + 1) * per]
                for t in tree_leaves(want_params["groups"][0])]
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(got["rows"]), rows))
        assert [float(x) for x in got["losses"]] == \
            [float(x) for x in want_losses]
        assert got["inflight"].shape == (1, 2 * gr.POD_BATCH // n_data,
                                         gr.POD_SEQ, 256)
        # the rank holds its own rows only (copies, not views of the
        # whole group) and Adam state for them alone
        assert all(held == own for held, own in got["storage"])
        assert got["opt_keys"] == ["groups"]
    assert seen == {(s, d) for s in range(stages) for d in range(n_data)}
    # stage s trains on the zero register at step 1 and first sees data
    # at step s + 1 (a block maps zeros to zeros, with zero grads): after
    # 3 steps the units of stage 3 of 4 are still the initial draw,
    # every other unit moved
    init = transformer.init(torch.Generator().manual_seed(0),
                            gr.pod_config())["groups"][0]
    fed = torch.tensor([r // per < gr.POD_STEPS
                        for r in range(gr.POD_BLOCKS)])
    for a, b in zip(tree_leaves(init), tree_leaves(want_params["groups"][0])):
        assert torch.equal((a != b).flatten(1).any(1), fed)


def test_pod_fit_on_four_ranks_matches_the_oracle(ranks, oracles):
    want_params, want_losses = oracles["fit"]
    for res in ranks:
        fit = res["fit"]
        assert fit["num_nodes"] == gr.WORLD
        assert [h for h, _ in fit["history"]] == list(
            range(1, gr.FIT_STEPS + 1))
        assert [l for _, l in fit["history"]] == \
            [float(x) for x in want_losses]
        assert pff_lm.lm_params_bit_equal(fit["params"], want_params)


@pytest.mark.parametrize("case", gr.MOE_CASES,
                         ids=[f"{n}-{b}x{s}" for n, b, s in gr.MOE_CASES])
def test_expert_parallel_moe_matches_no_dist(ranks, case, one_thread):
    name, B, S = case
    cfg, p, x = gr.moe_inputs(name, B, S)
    shards = x.chunk(2, dim=0)
    want = [tmlp.moe_apply(p, xs, cfg.moe, cfg.act) for xs in shards]
    T = B // 2 * S
    assert (T <= 64 * cfg.moe.top_k) == (S == 16)     # both branches
    mean_aux = (want[0][1] + want[1][1]) / 2
    for res in ranks:
        got = res[f"moe:{name}:{B}x{S}"]
        y_ref, _ = want[got["data"]]
        assert got["y"].shape == y_ref.shape
        assert float((got["y"] - y_ref).abs().max()) <= MOE_TOL
        assert math.isclose(float(got["aux"]), float(mean_aux),
                            rel_tol=1e-6)


# ---------------------------------------------------------------------------
# Against the reference's math (stages 1 x data 1, no process group)
# ---------------------------------------------------------------------------

def _configs():
    """The reduced tinyllama-1.1b at 2 blocks (tests/test_api.py's pod
    config), in both packages."""
    return [dataclasses.replace(get("tinyllama-1.1b").reduced(),
                                num_layers=2, groups=((("attn",), 2),))
            for get in (jget, tget)]


def _jax_pod_steps(jc, jp, batches, *, stages=1, n_data=1, lr, seed=0,
                   negs=None):
    """The reference's pod step composed from its parts, as a host loop
    over every (stage, data shard): a register list (zeros at step 1,
    stage s's output the next step's input of s + 1), each unit's
    per-shard grads averaged as ``pmean`` averages them (the sum over
    the shards, over their count) before its Adam step, the loss
    averaged over data and summed over stages. ``negs``: each step's
    negatives, or None to draw them with the reference's
    ``corrupt_tokens``. Returns (params, the per-step losses)."""
    pattern, repeat = jc.groups[0]
    theta = jc.ff.theta
    ctx = {"causal": True, "dist": J_NO_DIST}

    @jax.jit
    def unit_grads(unit, x, is_pos):
        def loss_fn(up):
            h, total = x, jnp.zeros(())
            for kind, bp in zip(pattern, up):
                h_sg = jax.lax.stop_gradient(h)
                y, aux = jblocks.block_apply(bp, jc, kind, h_sg, ctx)
                g = jff.mean_goodness(y - h_sg)
                total = total + jff.ff_loss_masked(g, is_pos, theta) \
                    + 0.01 * aux
                h = y
            return total, h
        (loss, y), grads = jax.value_and_grad(loss_fn, has_aux=True)(unit)
        return grads, jax.lax.stop_gradient(y), loss

    @jax.jit
    def adam(unit, grads, m, v, step):
        new, st = joptim.adam_update(unit, grads, {"m": m, "v": v}, lr=lr,
                                     step=step)
        return new, st["m"], st["v"]

    opt = joptim.adam_init(jp)
    gp, gm, gv = jp["groups"][0], opt["m"]["groups"][0], opt["v"]["groups"][0]
    per = repeat // stages
    regs, losses = None, []
    for step, tok in enumerate(batches, 1):
        tok = jnp.asarray(tok)[:, :-1]
        B = tok.shape[0]
        rows = 2 * B // n_data
        neg = (jnp.asarray(negs[step - 1]) if negs is not None else
               jff.corrupt_tokens(jax.random.fold_in(
                   jax.random.PRNGKey(seed), step), tok, jc.vocab))
        x_all = jnp.take(jp["embed"], jnp.concatenate([tok, neg]), axis=0)
        is_pos = jnp.concatenate([jnp.ones((B,)), jnp.zeros((B,))])
        shard = [slice(d * rows, (d + 1) * rows) for d in range(n_data)]
        if regs is None:
            zero = jnp.zeros((rows,) + x_all.shape[1:], x_all.dtype)
            regs = [[zero] * n_data for _ in range(stages)]
        new_regs, total = [None] * stages, 0.0
        for s in range(stages):
            xs = [x_all[sl] if s == 0 else regs[s][d]
                  for d, sl in enumerate(shard)]
            for r in range(s * per, (s + 1) * per):
                at = lambda t, r=r: t[r]                      # noqa: E731
                unit = jax.tree.map(at, gp)
                outs = [unit_grads(unit, x, is_pos[sl])
                        for x, sl in zip(xs, shard)]
                grads = jax.tree.map(lambda *g: sum(g[1:], g[0]) / n_data,
                                     *[o[0] for o in outs])
                new, m, v = adam(unit, grads, jax.tree.map(at, gm),
                                 jax.tree.map(at, gv), jnp.int32(step))
                put = lambda a, n, r=r: a.at[r].set(n)        # noqa: E731
                gp, gm, gv = (jax.tree.map(put, gp, new),
                              jax.tree.map(put, gm, m),
                              jax.tree.map(put, gv, v))
                xs = [o[1] for o in outs]
                total = total + float(np.mean([float(o[2]) for o in outs]))
            new_regs[(s + 1) % stages] = xs
        regs = new_regs
        losses.append(total)
    out = dict(jp)
    out["groups"] = (gp,)
    return out, losses


@pytest.fixture(scope="module")
def jax_pods():
    """The JAX host loop at each 4-rank layout, on the ranks' init and
    the port's draws of the negatives (``TorchKey``: the draws are held
    to the reference's at 1 x 1 below)."""
    cfg = gr.pod_config()
    jc = dataclasses.replace(jget("tinyllama-1.1b").reduced(),
                             num_layers=gr.POD_BLOCKS,
                             groups=((("attn",), gr.POD_BLOCKS),))
    init = transformer.init(torch.Generator().manual_seed(0), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(init))
    batches = list(tdata.lm_batches(cfg.vocab, gr.POD_BATCH, gr.POD_SEQ,
                                    gr.POD_STEPS))
    negs = [tff.corrupt_tokens(TorchKey(0).fold_in(step),
                               torch.as_tensor(t)[:, :-1], cfg.vocab).numpy()
            for step, t in enumerate(batches, 1)]
    return {layout: _jax_pod_steps(jc, jp, batches, stages=layout[0],
                                   n_data=layout[1], lr=gr.POD_LR, negs=negs)
            for layout in gr.POD_LAYOUTS}


@pytest.mark.parametrize("layout", gr.POD_LAYOUTS,
                         ids=[f"{s}x{d}" for s, d in gr.POD_LAYOUTS])
def test_pod_layouts_match_the_reference_math(ranks, jax_pods, layout):
    """Every rank's rows and loss at the repo's leaf rule and loss
    tolerance of the JAX host loop at the same layout."""
    stages, n_data = layout
    want, want_losses = jax_pods[layout]
    per = gr.POD_BLOCKS // stages
    for res in ranks:
        got = res[f"pod{stages}x{n_data}"]
        s = got["stage"]
        _assert_params_close(got["rows"], jax.tree_util.tree_map(
            lambda a: a[s * per:(s + 1) * per], want["groups"][0]))
        for a, b in zip(got["losses"], want_losses):
            assert _rel(a, b) <= LOSS_TOL, (float(a), b)


def test_pod_step_matches_the_reference_math(one_thread):
    jc, tc = _configs()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    batches = list(tdata.lm_batches(tc.vocab, 4, 32, 2))
    want, want_losses = _jax_pod_steps(jc, jp, batches, lr=1e-3)

    params = params_from_numpy(npp, "cpu")
    opt = pff_pod.init_opt_state(params)
    step = pff_pod.make_pff_pod_step(tc, None, lr=1e-3, seed=0,
                                     key_fn=JaxKey)
    inflight = pff_pod.init_inflight(tc, 4, 32)
    losses = []
    for i, tok in enumerate(batches):
        params, opt, inflight, m = step(params, opt,
                                        {"tokens": torch.as_tensor(tok)},
                                        inflight, i + 1)
        losses.append(float(m["loss_ff"]))
    _assert_params_close(params, want)
    for a, b in zip(losses, want_losses):
        assert _rel(a, b) <= LOSS_TOL, (a, b)
    # the block steps leave everything outside the group as it was
    assert torch.equal(params["embed"], params_from_numpy(npp, "cpu")["embed"])


def test_pod_backend_runs_lm_config(one_thread, deterministic):
    """The reference's ``test_pod_backend_runs_lm_config`` on the port,
    and the fit is the step above run on the fit's own init."""
    _, cfg = _configs()
    res = tapi.fit(cfg, backend="pod", num_nodes=1, steps=2, batch=4,
                   seq=32, device="cpu")
    assert res.backend == "pod" and len(res.history) == 2
    assert np.isfinite(res.history[-1][1])
    assert res.schedule == "pod_pipeline" and res.makespan > 0
    params = pff_lm.init_params(cfg, 0, "cpu")
    opt = pff_pod.init_opt_state(params)
    step = pff_pod.make_pff_pod_step(cfg, None, lr=1e-3, seed=0)
    inflight = pff_pod.init_inflight(cfg, 4, 32)
    for i, tok in enumerate(tdata.lm_batches(cfg.vocab, 4, 32, 2)):
        params, opt, inflight, m = step(params, opt,
                                        {"tokens": torch.as_tensor(tok)},
                                        inflight, i + 1)
        assert float(m["loss_ff"]) == res.history[i][1]
    assert pff_lm.lm_params_bit_equal(res.params, params)
    traced = tapi.fit(cfg, backend="pod", num_nodes=1, steps=1, batch=4,
                      seq=32, device="cpu", trace=True)
    assert [s.name for s in traced.trace.snapshot()] == ["fit:pod"]


@pytest.mark.parametrize("q_offset", [0, 8])
def test_block_apply_takes_the_reference_q_offset(q_offset, one_thread):
    """``ctx["q_offset"]`` shifts the rope of q and k and the queries'
    mask positions, as the reference's ``block_apply`` does (keys' mask
    positions from 0: the first rows see every key)."""
    jc, tc = _configs()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    bp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                jp["groups"][0][0])
    x = np.random.default_rng(3).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    want, _ = jblocks.block_apply(bp, jc, "attn", jnp.asarray(x),
                                  {"causal": True, "q_offset": q_offset})
    got, _ = tblocks.block_apply(params_from_numpy(bp, "cpu"), tc, "attn",
                                 torch.tensor(x),
                                 {"causal": True, "q_offset": q_offset})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pod_backend_needs_a_group_for_more_stages():
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="torchrun"):
        tapi.fit(cfg, backend="pod", num_nodes=2, steps=1, batch=2, seq=8,
                 device="cpu")
    with pytest.raises(AssertionError):           # 2 blocks over 4 stages
        pff_pod.make_pff_pod_step(cfg, type("M", (), {
            "shape": {"stage": 4, "data": 1, "model": 1}})(), lr=1e-3)
