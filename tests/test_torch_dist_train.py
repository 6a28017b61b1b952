"""The port's LM steps and entry points under a ``Dist`` (expert
parallelism over a (data 2, model 2) mesh, fsdp on data) on the CPU.

Two processes start together from the module's fixture, on inputs this
file writes (initial params of the reduced configs, token batches, and
the reference's random draws recorded by their fold/split path,
``RecordingKey``):

* ``jax_dist_ref`` runs the reference's ``make_ff_train_step`` (S 16,
  the MoE's dense-local branch; S 80, the sorted one; AdaptiveNEG at S
  16, whose draw is recorded as its Gumbel noise) and
  ``make_bp_train_step`` of the reduced deepseek-moe-16b under its
  ``Dist``, and the reduced qwen2-0.5b's FF step with the model axis
  folded into the batch, under ``jax.jit`` on 4 host devices;
* ``torch_gloo_ranks dist`` runs the port's on 4 gloo ranks that load
  no jax, each holding its shards of the expert weights and their Adam
  state, the negatives replayed from the recorded draws.

Each rank's tree, gathered back, is held against the reference's at the
repo's leaf rule (``test_torch_lm_train._assert_params_close``), and its
metrics within ``LOSS_TOL``. The MoE's grads on each rank's shards are
held within ``MOE_TOL`` (relative to the leaf's largest grad) of the
grads of the mean of the per-shard ``NO_DIST`` losses, in both branches
of both MoE configs; ``prefill`` and ``serve_step`` on a rank's shard of
the prompts within ``SERVE_TOL`` of ``NO_DIST`` on that shard; and
``make_dist``'s fields equal the reference's for every config.
"""
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro_torch import sharding
from repro_torch.configs import get_config as tget, list_configs
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 tree_leaves)
from repro_torch.core import ff as tff
from repro_torch.launch.dryrun import make_dist
from repro_torch.launch.specs import SizesMesh
from repro_torch.models import mlp as tmlp, transformer

import torch_gloo_ranks as gr
from test_torch_lm_train import LOSS_TOL, _assert_params_close, _rel
from test_torch_lm_train import one_thread  # noqa: F401
from test_torch_train import JaxKey

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_TOL = 1e-5
SERVE_TOL = 1e-5
MESH = SizesMesh({"data": 2, "model": 2})


class RecordingKey:
    """``JaxKey`` that records every draw under
    ``torch_gloo_ranks.draw_key`` of its fold/split path, for
    ``ReplayKey`` to hand the ranks."""

    def __init__(self, key, path, draws):
        self.key, self.path, self.draws = key, path, draws

    def fold_in(self, data):
        return RecordingKey(self.key.fold_in(data),
                            self.path + ("f", int(data)), self.draws)

    def split(self, n):
        return [RecordingKey(k, self.path + ("s", n, i), self.draws)
                for i, k in enumerate(self.key.split(n))]

    def _record(self, method, shape, t):
        name = gr.draw_key(self.path, method, tuple(shape))
        arr = t.numpy()
        assert name not in self.draws or np.array_equal(self.draws[name],
                                                        arr), name
        self.draws[name] = arr
        return t

    def permutation(self, n):
        return self._record("permutation", (n,), self.key.permutation(n))

    def randint(self, shape, low, high):
        return self._record("randint", shape,
                            self.key.randint(shape, low, high))

    def normal(self, shape):
        return self._record("normal", shape, self.key.normal(shape))

    def bernoulli(self, shape, p):
        return self._record("bernoulli", shape, self.key.bernoulli(shape, p))

    def categorical(self, logits):
        """The Gumbel noise ``jax.random.categorical`` adds (it takes the
        argmax of logits + noise): the draw depends on the logits, which
        the replaying rank supplies."""
        g = jax.random.gumbel(self.key.key, tuple(logits.shape),
                              jnp.float32)
        draw = jax.random.categorical(self.key.key, jnp.asarray(logits))
        assert np.array_equal(np.asarray(draw), np.asarray(
            jnp.argmax(jnp.asarray(logits) + g, axis=-1)))
        self._record("gumbel", logits.shape, torch.tensor(np.asarray(g)))
        return torch.tensor(np.asarray(draw))


def _inputs():
    """The reduced configs' initial params (the port's init, as numpy)
    and token batches."""
    rng = np.random.default_rng(26)
    out = {}
    for name, key, cases in (
            ("deepseek-moe-16b", "deepseek", gr.DIST_STEPS),
            ("qwen2-0.5b", "qwen2", {"ff": 16})):
        cfg = tget(name).reduced()
        out[key] = {"params": params_to_numpy(transformer.init(
            torch.Generator().manual_seed(0), cfg))}
        for case, S in cases.items():
            out[key][case] = rng.integers(
                0, cfg.vocab, (gr.DIST_BATCH, S + 1)).astype(np.int32)
    out["deepseek"]["prompts"] = rng.integers(
        0, 512, (gr.DIST_BATCH, gr.DIST_PROMPT + gr.DIST_GEN)
    ).astype(np.int32)
    return out


def _draws(inputs):
    """The reference's draws of each FF step's negatives (seed 0, step
    1), by their fold/split path."""
    draws = {}
    for key, name in (("deepseek", "deepseek-moe-16b"),
                      ("qwen2", "qwen2-0.5b")):
        vocab = jget(name).reduced().vocab
        for case in ("ff16", "ff80", "ff", "ada16"):
            if case not in inputs[key]:
                continue
            rk = RecordingKey(JaxKey(0), (0,), draws).fold_in(1)
            pos = torch.as_tensor(inputs[key][case][:, :-1])
            if case == "ada16":
                # the noise depends on the logits' shape alone
                tff.adaptive_corrupt_tokens(rk, pos, torch.zeros(
                    tuple(pos.shape) + (tget(name).reduced().padded_vocab,)))
            else:
                tff.corrupt_tokens(rk, pos, vocab)
    return draws


# the reference's cases, split over two processes that run side by side
REF_CASES = (("make_dist", "ff16", "ff80"), ("bp", "ada16", "fold"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results by case, one dict per rank): the
    reference's processes start first, the ranks once the draws are
    recorded; all run at once."""
    out = tmp_path_factory.mktemp("dist_ranks")
    inputs = _inputs()
    with open(out / "dist_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")

    def start(args, e):
        return subprocess.Popen([sys.executable, "-m", *args], env=e,
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start(["jax_dist_ref", str(out), *cases], ref_env)
             for cases in REF_CASES]
    with open(out / "dist_draws.pkl", "wb") as f:
        pickle.dump(_draws(inputs), f)
    procs.append(start(["torch_gloo_ranks", "dist", str(out)], env))
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, so[-4000:] + se[-4000:]
    ref = {}
    for case in sum(REF_CASES, ()):
        with open(out / f"ref_{case}.pkl", "rb") as f:
            ref[case] = pickle.load(f)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(gr.WORLD)]
    assert all(r["leaked"] == [] for r in ranks)      # no rank loaded jax
    return inputs, ref, ranks


def _specs(tree, cfg):
    return transformer.held_specs(
        tree, cfg, tmlp.Dist(MESH, ("data",), "model", "data"))


@pytest.mark.parametrize("case", gr.MOE_CASES,
                         ids=[f"{n}-{b}x{s}" for n, b, s in gr.MOE_CASES])
def test_expert_parallel_moe_grads_match_the_per_shard_oracle(runs, case,
                                                               one_thread):
    """Each rank's grads of its shards (replicated leaves summed over the
    batch axis) against the grads of the mean over the two token shards
    of ``sum(y * c) + aux_weight * aux`` under ``NO_DIST``."""
    name, B, S = case
    cfg, p, x = gr.moe_inputs(name, B, S)
    assert (B // 2 * S <= 64 * cfg.moe.top_k) == (S == 16)  # both branches
    leaves = [t.requires_grad_() for t in tree_leaves(p)]
    loss = 0.0
    for xs, cs in zip(x.chunk(2), gr.moe_cotangent(x).chunk(2)):
        y, aux = tmlp.moe_apply(p, xs, cfg.moe, cfg.act)
        loss = loss + ((y * cs).sum() + gr.DIST_AUX * aux) / 2
    want = torch.autograd.grad(loss, leaves)
    specs = _specs({"mlp": p}, cfg)
    for res in runs[2]:
        got = res[f"grad:{name}:{B}x{S}"]
        assert len(got) == len(want)
        for g, w, spec in zip(got, want, specs):
            w = sharding.local_shard(w, spec, MESH, res["coords"])
            assert g.shape == w.shape
            err = float((g - w).abs().max() / w.abs().max())
            assert err <= MOE_TOL, (spec, err)


@pytest.mark.parametrize("case", ["ff16", "ff80", "bp", "ada16", "fold"])
def test_steps_under_dist_match_the_references(runs, case):
    """The FF steps at S 16 (dense-local MoE) and S 80 (sorted), the
    backprop step, the AdaptiveNEG FF step (the draw from the logits the
    ranks gathered), and the dense config's FF step with the model axis
    in the batch axes: every rank's gathered tree and metrics against
    the reference's step under the same ``Dist``."""
    _, ref, ranks = runs
    want, want_metrics = ref[case]
    for res in ranks:
        got = res[case]
        _assert_params_close(got["params"], want)
        assert sorted(got["metrics"]) == sorted(want_metrics)
        for k, v in want_metrics.items():
            assert _rel(got["metrics"][k], v) <= LOSS_TOL, \
                (k, got["metrics"][k], v)


def test_each_rank_holds_its_expert_shards_only(runs):
    """The expert weights and their Adam m and v are the rank's blocks
    (copies: the storage holds the block alone); every other leaf is
    whole."""
    inputs, _, ranks = runs
    cfg = tget("deepseek-moe-16b").reduced()
    full = params_from_numpy(inputs["deepseek"]["params"], "cpu")
    specs = _specs(full, cfg)
    split = [any(e is not None for e in s) for s in specs]
    assert sum(split) == 6      # wi, wg, wo and the shared experts' three
    for res in ranks:
        for case in ("ff16", "ff80", "bp", "ada16"):
            held = res[case]["held"]
            want = [tuple(sharding.local_shard(t, s, MESH, res["coords"])
                          .shape) for t, s in zip(tree_leaves(full), specs)]
            assert [h[0] for h in held] == want
            assert res[case]["opt"] == want + want
            for (shape, nbytes), t, s in zip(held, tree_leaves(full), split):
                if s:
                    assert nbytes == int(np.prod(shape)) * t.element_size()


def test_prefill_and_decode_under_dist_equal_no_dist(runs, one_thread):
    """``prefill`` and ``serve_step`` on each rank's shard of the prompts
    (its expert shards, the MoE expert-parallel) against ``NO_DIST`` on
    that shard: the sorted branch in prefill, the dense-local one in
    decode."""
    inputs, _, ranks = runs
    cfg = tget("deepseek-moe-16b").reduced()
    params = params_from_numpy(inputs["deepseek"]["params"], "cpu")
    prompts = torch.as_tensor(inputs["deepseek"]["prompts"])
    P, G = gr.DIST_PROMPT, gr.DIST_GEN
    for res in ranks:
        rows = prompts.chunk(2)[res["coords"]["data"]]
        assert rows.shape[0] * P > 64 * cfg.moe.top_k      # sorted
        logits, caches = transformer.prefill(params, cfg, rows[:, :P],
                                             max_len=P + G, impl="ref")
        want = [logits]
        for i in range(G):
            logits, caches = transformer.serve_step(params, cfg, caches,
                                                    rows[:, P + i], P + i)
            want.append(logits)
        for g, w in zip(res["serve"], want):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= SERVE_TOL * float(
                w.abs().max())


def test_make_dist_matches_the_references(runs):
    """The batch, model and fsdp axes for every config, with and without
    the model axis folded into the batch, on the (data 2, model 2) mesh
    (the ranks' ``DeviceMesh``) and a (pod 1, data 2, model 2) one."""
    _, ref, ranks = runs
    pod = SizesMesh({"pod": 1, "data": 2, "model": 2})
    assert len({k[0] for k in ref["make_dist"]}) == len(list_configs())
    for name in list_configs():
        for fold in (False, True):
            want = ref["make_dist"][name, "2x2", fold]
            assert all(r["make_dist"][name, fold] == want for r in ranks)
            d = make_dist(tget(name), pod, batch_fold_model=fold)
            assert (d.batch_axes, d.model_axis, d.fsdp_axis) == \
                ref["make_dist"][name, "pod", fold]
