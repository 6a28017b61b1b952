"""The port's LM steps and entry points under a ``Dist`` on the CPU:
each rank holds the blocks of the reference's ``param_specs`` (checked
leaf by leaf against the reference's own rules for every config on four
meshes), attention and the dense MLP tensor-parallel over "model", the
MoE expert-parallel, fsdp on "data".

Two processes start together from the module's fixture, on inputs this
file writes (initial params of the reduced configs, token batches, and
the reference's random draws recorded by their fold/split path,
``RecordingKey``):

* ``jax_dist_ref`` runs the reference's ``make_ff_train_step`` (S 16,
  the MoE's dense-local branch; S 80, the sorted one; AdaptiveNEG at S
  16, whose draw is recorded as its Gumbel noise) and
  ``make_bp_train_step`` of the reduced deepseek-moe-16b under its
  ``Dist``, the reduced qwen2-0.5b's FF step with the model axis folded
  into the batch, and the tensor-parallel cases
  (``torch_gloo_ranks.TP_CASES``, which hit the three head cases: heads
  and kv heads split, query heads only, none), under ``jax.jit`` on 4
  host devices, its params placed by its ``param_specs``;
* ``torch_gloo_ranks dist`` runs the port's on 4 gloo ranks that load
  no jax, each holding its blocks and their Adam state, the negatives
  replayed from the recorded draws; the tensor-parallel cases on (data
  2, model 2) and (data 1, model 4).

Each rank's tree, gathered back, is held against the reference's at the
repo's leaf rule (``test_torch_lm_train._assert_params_close``), and its
metrics within ``LOSS_TOL``; the tensor-parallel cases' raw grads
against ``NO_DIST``'s within ``MOE_TOL``, their prefill and greedy
decode against the reference's logits and tokens within ``SERVE_TOL``,
the tokens ``NO_DIST``'s too. The MoE's grads on each rank's shards are
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
from jax.sharding import PartitionSpec
import torch

from repro import optim as joptim, sharding as jsharding
from repro.configs import get_config as jget
from repro.models import transformer as jtransformer
from repro_torch import sharding
from repro_torch.configs import get_config as tget, reference_names
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
        # by its range too: the cases' vocabularies differ
        return self._record(f"randint[{low},{high})", shape,
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


def _tp_inputs(rng):
    """Each tensor-parallel case's inputs: its config, a token batch,
    prompts and the stub embeddings where the config reads them, and
    whether its backprop step runs (its params are the reference's own
    init, drawn by ``jax_dist_ref``)."""
    out = {}
    for name, base, fields in gr.TP_CASES:
        jc = gr.tp_config(jget, base, fields)
        case = {"base": base, "fields": fields, "bp": name in gr.TP_BP,
                "gen": gr.TP_GEN,
                "tokens": rng.integers(0, jc.vocab, (
                    gr.TP_BATCH, gr.TP_SEQ + 1)).astype(np.int32),
                "prompts": rng.integers(0, jc.vocab, (
                    gr.TP_BATCH, gr.TP_PROMPT)).astype(np.int32)}
        if jc.vision_tokens:
            case["aux"] = rng.standard_normal(
                (gr.TP_BATCH, jc.vision_tokens, jc.d_model)
            ).astype(np.float32)
        out[name] = case
    return out


def _b1_inputs(rng):
    """Each batch-1 decode case's config and its one prompt."""
    return {name: {"base": base, "fields": fields, "gen": gen,
                   "prompts": rng.integers(0, gr.tp_config(
                       jget, base, fields).vocab, (1, P)).astype(np.int32)}
            for name, base, fields, P, gen in gr.B1_CASES}


def _inputs():
    """The reduced configs' initial params (the port's init, as numpy)
    and token batches; the tensor-parallel cases' (``_tp_inputs``) and
    the batch-1 decode cases' (``_b1_inputs``)."""
    rng = np.random.default_rng(26)
    out = {"tp": _tp_inputs(np.random.default_rng(28)),
           "b1": _b1_inputs(np.random.default_rng(29))}
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
    for case in inputs["tp"].values():
        rk = RecordingKey(JaxKey(0), (0,), draws).fold_in(1)
        tff.corrupt_tokens(rk, torch.as_tensor(case["tokens"][:, :-1]),
                           gr.tp_config(jget, case["base"],
                                        case["fields"]).vocab)
    return draws


# the reference's cases, split over two processes that run side by side
TP_NAMES = [name for name, _, _ in gr.TP_CASES]
B1_NAMES = [name for name, *_ in gr.B1_CASES]
REF_CASES = (("make_dist", "ff16", "ff80", "tp:qwen3-8b",
              "tp:recurrentgemma-2b", "b1:recurrentgemma-2b",
              "b1:mamba2-780m"),
             ("bp", "ada16", "fold", "tp:qwen2-odd",
              "tp:llama-3.2-vision-90b", "tp:mamba2-780m",
              "b1:h2o-danube-3-4b"))


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
    for name, case in inputs["tp"].items():
        case["params"] = gr.tp_params(out, name, timeout=0)
    for name, case in inputs["b1"].items():
        case["params"] = gr.tp_params(out, f"b1-{name}", timeout=0)
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
    """The expert weights, and now every other leaf too, with their Adam
    m and v, are the rank's blocks of the reference's rules
    (``sharding.param_specs``: the experts' and their d_model's, and the
    dense leaves' heads, ff, d_model and vocab), copies whose storage
    holds the block alone; a leaf the rules replicate is whole."""
    inputs, _, ranks = runs
    cfg = tget("deepseek-moe-16b").reduced()
    full = params_from_numpy(inputs["deepseek"]["params"], "cpu")
    specs = _specs(full, cfg)
    rules = []
    sharding.map_with_path(lambda path, t: rules.append(
        sharding.leaf_spec(path, t.shape, MESH)), full)
    assert specs == rules
    split = [any(e is not None for e in s) for s in specs]
    assert sum(split) == 12     # embed, lm_head, attn 4, experts 3, shared 3
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
    assert len({k[0] for k in ref["make_dist"]}) == len(reference_names())
    for name in reference_names():
        for fold in (False, True):
            want = ref["make_dist"][name, "2x2", fold]
            assert all(r["make_dist"][name, fold] == want for r in ranks)
            d = make_dist(tget(name), pod, batch_fold_model=fold)
            assert (d.batch_axes, d.model_axis, d.fsdp_axis) == \
                ref["make_dist"][name, "pod", fold]


# ---------------------------------------------------------------------------
# Tensor-parallel dense weights: what a rank holds, and its steps
# ---------------------------------------------------------------------------

class _Sizes:
    """A mesh of axis sizes, for the reference's rules (``.shape``)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


SPEC_MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
               "pod1": {"data": 16, "model": 16},
               "pod2": {"pod": 2, "data": 16, "model": 16}}


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]


@pytest.mark.parametrize("name", reference_names())
def test_held_specs_are_the_references_param_specs(name):
    """For every leaf of the params and of Adam's m and v (the
    reference's init and ``adam_init``, ``jax.eval_shape``'d: published
    widths, no storage), the port's held spec on a mesh of sizes equals
    the reference's ``param_specs``, on (2, 2), (1, 4), pod1 and pod2;
    and a unit's views take their stacked leaf's spec without its R
    entry."""
    jc = jget(name)
    params = jax.eval_shape(lambda: jtransformer.init(jax.random.PRNGKey(0),
                                                      jc))
    opt = jax.eval_shape(joptim.adam_init, params)
    cfg = tget(name)
    for label, sizes in SPEC_MESHES.items():
        d = make_dist(cfg, SizesMesh(sizes))
        for tree in (params, opt["m"], opt["v"]):
            want = dict(zip(_jax_paths(tree), (
                tuple(p) for p in jax.tree_util.tree_leaves(
                    jsharding.param_specs(tree, _Sizes(sizes)),
                    is_leaf=lambda x: isinstance(x, PartitionSpec)))))
            got = transformer.held_specs(tree, cfg, d)
            paths = []
            sharding.map_with_path(lambda p, t: paths.append("/".join(p)),
                                   tree)
            assert len(got) == len(want) == len(paths)
            for path, spec in zip(paths, got):
                assert spec == want[path], (label, path)
        unit = tuple(jax.tree_util.tree_map(
            lambda t: jax.ShapeDtypeStruct(t.shape[1:], t.dtype), blk)
            for blk in params["groups"][0])
        stacked = transformer.held_specs({"groups": (params["groups"][0],)},
                                         cfg, d)
        assert transformer.held_specs(unit, cfg, d) == [s[1:]
                                                        for s in stacked]


def _rows(t, coords, layout):
    """Rank ``coords``'s block of the batch rows of ``t`` (data-major)."""
    n = layout[0]
    return np.split(np.asarray(t), n)[coords["data"]]


TP_IDS = [f"{n}-{a}x{b}" for n in TP_NAMES for a, b in gr.TP_LAYOUTS]
TP_PARAMS = [(n, layout) for n in TP_NAMES for layout in gr.TP_LAYOUTS]
TP_STEPS = [("ff",) + p for p in TP_PARAMS] + [
    ("bp",) + p for p in TP_PARAMS if p[0] in gr.TP_BP]


@pytest.mark.parametrize("kind,name,layout", TP_STEPS,
                         ids=[f"{k}-{n}-{a}x{b}" for k, n, (a, b)
                              in TP_STEPS])
def test_tensor_parallel_steps_match_the_references(runs, kind, name,
                                                    layout):
    """The FF step (random negatives, replayed) of each tensor-parallel
    case, and the backprop step of the three head cases (``TP_BP``), on
    4 gloo ranks, each holding the blocks of the reference's whole
    params (its own init) that its ``param_specs`` gives it:
    every rank's tree gathered back and its metrics against the
    reference's step on its placed params, at the repo's leaf rule and
    ``LOSS_TOL``."""
    _, ref, ranks = runs
    want, want_metrics = ref[f"tp:{name}"][kind]
    for res in ranks:
        got = res[f"tp:{name}:{layout}"][kind]
        _assert_params_close(got["params"], want)
        assert sorted(got["metrics"]) == sorted(want_metrics)
        for k, v in want_metrics.items():
            assert _rel(got["metrics"][k], v) <= LOSS_TOL, \
                (k, got["metrics"][k], v)


@pytest.mark.parametrize("name,layout", TP_PARAMS, ids=TP_IDS)
def test_tensor_parallel_grads_match_no_dist(runs, name, layout,
                                             one_thread):
    """The backprop loss's grads of the blocks each rank holds (summed
    as the step sums them) against the rank's blocks of ``NO_DIST``'s
    grads of the whole params, within ``MOE_TOL`` of each leaf's largest:
    a transpose off by the model axis's size shows here, where Adam's
    first step, which divides each grad by its size, would hide it."""
    inputs, _, ranks = runs
    case = inputs["tp"][name]
    cfg = gr.tp_config(tget, case["base"], case["fields"])
    params = params_from_numpy(case["params"], "cpu")
    tokens = torch.as_tensor(case["tokens"])
    aux = case.get("aux")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    logits, _ = transformer.forward(
        params, cfg, tokens[:, :-1], impl="ref",
        aux=None if aux is None else torch.as_tensor(aux))
    ce = -torch.log_softmax(logits, -1).gather(
        -1, tokens[:, 1:].long()[..., None])[..., 0]
    want = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(ce.mean(), leaves, allow_unused=True))]
    mesh = SizesMesh(dict(zip(("data", "model"), layout)))
    specs = transformer.held_specs(params, cfg, make_dist(cfg, mesh))
    for res in ranks:
        got = res[f"tp:{name}:{layout}"]["grads"]
        assert len(got) == len(want)
        for g, w, spec in zip(got, want, specs):
            w = sharding.local_shard(w, spec, mesh, res[f"coords:{layout}"])
            assert g.shape == w.shape
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= MOE_TOL * max(scale, 1e-30)


@pytest.mark.parametrize("name,layout", TP_PARAMS, ids=TP_IDS)
def test_tensor_parallel_serve_matches_the_reference(runs, name, layout,
                                                     one_thread):
    """Prefill and ``TP_GEN`` greedy decode steps on each rank's block
    of the prompts: its logits within ``SERVE_TOL`` of the reference's
    (placed params, the whole batch) on its rows, its tokens the
    reference's and ``NO_DIST``'s; its caches hold its own kv heads
    where KV splits over "model", else every one."""
    inputs, ref, ranks = runs
    case = inputs["tp"][name]
    cfg = gr.tp_config(tget, case["base"], case["fields"])
    want = ref[f"tp:{name}"]["serve"]
    params = params_from_numpy(case["params"], "cpu")
    for res in ranks:
        coords = res[f"coords:{layout}"]
        got = res[f"tp:{name}:{layout}"]["serve"]
        for g, w in zip(got["logits"], want["logits"]):
            w = _rows(w, coords, layout)
            assert g.shape == w.shape
            assert float(np.abs(g.numpy() - w).max()) <= SERVE_TOL * float(
                np.abs(w).max())
        for g, w in zip(got["tokens"], want["tokens"]):
            assert np.array_equal(g.numpy(), _rows(w, coords, layout))
        rows = torch.as_tensor(_rows(case["prompts"], coords, layout))
        aux = case.get("aux")
        aux = None if aux is None else torch.as_tensor(
            _rows(aux, coords, layout))
        logits, caches = transformer.prefill(
            params, cfg, rows, aux=aux, max_len=gr.TP_PROMPT + gr.TP_GEN,
            impl="ref")
        for i, tok in enumerate(got["tokens"]):
            last = logits[:, -1] if logits.dim() == 3 else logits
            assert torch.equal(tok, last.argmax(-1).int())
            logits, caches = transformer.serve_step(
                params, cfg, caches, tok, gr.TP_PROMPT + i)
        m = layout[1]
        split = cfg.n_heads % m == 0 and cfg.n_kv % m == 0
        has_attn = any(k != "mamba2" for p, _ in cfg.groups for k in p)
        assert got["kv_heads"] == ([cfg.n_kv // m if split else cfg.n_kv]
                                   if has_attn else [])
        assert got["vocab_block"] == cfg.padded_vocab // m
        _assert_cache_blocks(got["caches"], want["caches"], layout, coords,
                             seq_axis_model=False)


def _assert_cache_blocks(got, want, layout, coords, *, seq_axis_model):
    """Each cache leaf a rank holds is its block, under
    ``sharding.cache_specs_tree(seq_axis_model=)``'s spec, of the
    reference's whole leaf at the same path: the positions its slots
    hold exactly, the values within ``SERVE_TOL`` of the leaf's
    largest."""
    mesh = SizesMesh(dict(zip(("data", "model"), layout)))
    held = {}
    sharding.map_with_path(lambda p, t: held.__setitem__(p, t), got)
    n = 0

    def one(path, w):
        nonlocal n
        spec = sharding.cache_leaf_spec(w.shape, mesh, seq_axis_model)
        w = sharding.local_shard(torch.as_tensor(np.asarray(w)), spec,
                                 mesh, coords)
        g = held[path]
        assert g.shape == w.shape, (path, spec)
        if not g.dtype.is_floating_point:
            assert torch.equal(g, w.to(g.dtype)), path
        else:
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= SERVE_TOL * scale, path
        n += 1

    sharding.map_with_path(one, want)
    assert n == len(held) > 0


@pytest.mark.parametrize("name,layout", [(n, lay) for n in B1_NAMES
                                         for lay in gr.TP_LAYOUTS],
                         ids=[f"{n}-{a}x{b}" for n in B1_NAMES
                              for a, b in gr.TP_LAYOUTS])
def test_batch_one_decode_on_split_caches_matches_the_reference(
        runs, name, layout):
    """One prompt served on 4 gloo ranks, every rank holding it whole
    (no data axis splits a batch of 1): prefill then greedy decode, the
    logits made whole from the ranks' vocab blocks within ``SERVE_TOL``
    of the reference's ``serve_step`` under its ``Dist``, the tokens its
    own; each rank's caches its blocks of the reference's under
    ``cache_specs_tree(seq_axis_model=True)``: attention's slots split
    over "model" (the windows' rings wrapped), mamba2's state on its
    heads."""
    inputs, ref, ranks = runs
    want = ref[f"b1:{name}"]["serve"]
    case = inputs["b1"][name]
    cfg = gr.tp_config(tget, case["base"], case["fields"])
    assert case["prompts"].shape[1] > (cfg.rglru.window if cfg.rglru
                                       else cfg.window or 0)
    split = []
    for res in ranks:
        got = res[f"b1:{name}:{layout}"]
        for g, w in zip(got["logits"], want["logits"]):
            assert g.shape == w.shape
            assert float(np.abs(g.numpy() - w).max()) <= SERVE_TOL * float(
                np.abs(w).max())
        for g, w in zip(got["tokens"], want["tokens"]):
            assert np.array_equal(g.numpy(), w)
        _assert_cache_blocks(got["caches"], want["caches"], layout,
                             res[f"coords:{layout}"], seq_axis_model=True)
        sharding.map_with_path(lambda p, t: split.append(t.shape[2]) if
                               p[-1] in ("k", "h") and t.dim() == 5 else None,
                               got["caches"])
    # every rank holds 1 / m of each attention cache's slots, or of the
    # SSM state's heads
    whole = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim if cfg.ssm
             else min(cfg.rglru.window if cfg.rglru else cfg.window,
                      case["prompts"].shape[1] + case["gen"]))
    assert set(split) == {whole // layout[1]}


def test_greedy_over_vocab_blocks_is_argmax():
    """``transformer.first_max`` over the blocks' (largest value, first
    index) candidates picks what ``torch.argmax`` picks over the whole
    row, ties to the lowest index, within a block and across a block
    boundary."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randint(0, 6, (64, 16), generator=g).float()
    logits[0, 3] = logits[0, 4] = 9.0       # a tie across blocks 0 and 1
    logits[1, 9] = logits[1, 10] = 9.0      # a tie within block 2
    logits[2, :] = 1.0                      # every entry equal
    for m in (1, 2, 4, 8):
        n = 16 // m
        vals, idx = logits.reshape(64, m, n).max(-1)
        idx = idx + torch.arange(m) * n
        got = transformer.first_max(vals, idx)
        assert torch.equal(got, logits.argmax(-1)), m
    assert got[0] == 3 and got[1] == 9 and got[2] == 0


@pytest.mark.parametrize("layout", gr.TP_LAYOUTS)
def test_gather_params_undoes_shard_params_for_every_config(runs, layout):
    for res in runs[2]:
        for name in reference_names():
            assert res[f"identity:{name}:{layout}"], name
