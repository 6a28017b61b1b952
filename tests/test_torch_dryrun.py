"""The port's fake-tensor dry run against the reference's lowering dry run:
the op analyzer (``repro_torch.launch.op_analysis``, the counterpart of
``repro.launch.hlo_analysis``) counts known programs exactly, as the
reference's ``tests/test_hlo_analysis.py`` holds its analyzer, plus its
view, in-place-write, peak and collective rules on hand-counted cases,
and the dot flops of a PAPER_MLP-shaped forward + grad and of reduced LM
prefills equal the reference's on its compiled ``jax.jit``; the stand-ins
(``launch.specs``) have the reference's shapes and dtypes for every
config x input shape, and their spec trees under a sizes-only mesh equal
``repro.sharding``'s; ``combo_is_applicable`` and ``model_flops`` equal
the reference's for every combination; one reduced config of each
family traces its step with every output a fake tensor.

Nothing here allocates a full-size tensor: the full configs are fake.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro import sharding as jsh
from repro.configs import INPUT_SHAPES as J_SHAPES, get_config as jget
from repro.configs import list_configs
from repro.kernels import ops as jops
from repro.launch import hlo_analysis, specs as jspecs
from repro.models import transformer as jtr
from repro_torch.configs import INPUT_SHAPES, get_config as tget
from repro_torch.convert import tree_leaves
from repro_torch.kernels import ops as tops
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.models import transformer as ttr


def _hlo(fn, *args):
    comp = jax.jit(fn).lower(*args).compile()
    return hlo_analysis.analyze(comp.as_text())


# ---------------------------------------------------------------------------
# The op analyzer (tests/test_hlo_analysis.py's three cases, then the rules)
# ---------------------------------------------------------------------------

def test_loop_of_matmuls_flops_exact():
    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    with specs.new_mode():
        x, w = torch.empty(128, 256), torch.empty(256, 256)
        res = op_analysis.analyze(f, x, w)
    assert res["flops"] == 7 * 2 * 128 * 256 * 256
    # the dot operands and outputs each iteration, and tanh's
    assert res["bytes"] >= 7 * (2 * 128 * 256 + 256 * 256) * 4
    assert res["bytes"] == 7 * (4 * 128 * 256 + 256 * 256) * 4


def test_nested_loops_flops_exact():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    x, w = torch.zeros(64, 64), torch.zeros(64, 64)
    res = op_analysis.analyze(f, x, w)
    assert res["flops"] == 5 * 3 * 2 * 64 * 64 * 64


def test_no_collectives_on_single_device():
    x = torch.zeros(32, 32)
    res = op_analysis.analyze(lambda x: x @ x, x)
    assert res["collective_bytes"] == 0
    assert all(v == 0 for v in res["collective_counts"].values())
    assert res["flops"] == 2 * 32 * 32 * 32


def test_views_inplace_writes_and_peak_hand_counted():
    def g(c, u):
        c[2:4] = u            # slice (a view: 0) + copy_ of 2x the update
        v = c[1:3]            # a view: 0
        c.add_(1.0)           # in place: read c, write c
        return v.clone()      # read and write the view's 128 bytes

    def h(x):
        a = x * 2             # +N live
        b = a * 3             # +N: args + 2N, the peak
        del a                 # -N
        return b + 1          # +N: args + 2N again

    with specs.new_mode():
        c, u = torch.empty(8, 16), torch.empty(2, 16)
        res = op_analysis.analyze(g, c, u)
        assert res["bytes"] == 2 * 128 + 2 * 512 + 2 * 128
        assert res["memory"] == {
            "argument_size_in_bytes": 512 + 128,
            "output_size_in_bytes": 128, "peak_size_in_bytes": 640 + 128,
            "temp_size_in_bytes": 128}
        x = torch.empty(1000)
        res = op_analysis.analyze(h, x)
    N = 4000
    assert res["bytes"] == 3 * 2 * N
    assert res["memory"] == {"argument_size_in_bytes": N,
                             "output_size_in_bytes": N,
                             "peak_size_in_bytes": 3 * N,
                             "temp_size_in_bytes": 2 * N}


def test_collectives_counted_by_type():
    """A world-size-1 gloo group: an all_reduce and an all_gather are
    recorded with their result bytes."""
    if dist.is_initialized():
        pytest.fail("a default process group is already initialized")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        def f(t):
            dist.all_reduce(t)
            out = torch.empty(8)
            gather = getattr(dist, "all_gather_single", None) \
                or dist.all_gather_into_tensor
            gather(out, t)
            return out

        res = op_analysis.analyze(f, torch.ones(8))
    finally:
        dist.destroy_process_group()
    assert res["collective_counts"]["all-reduce"] == 1
    assert res["collective_counts"]["all-gather"] == 1
    assert res["collective_by_type"]["all-reduce"] == 32
    assert res["collective_by_type"]["all-gather"] == 32
    assert res["collective_bytes"] == 64.0


def test_paper_mlp_forward_and_grad_dot_flops_equal_the_reference():
    """Two ff_dense layers of PAPER_MLP's shape at reduced widths
    (784 -> 200 -> 200, M 64; the norm epilogue between them), each
    layer's FF loss, grads of every weight and bias, impl="ref" on both
    sides: the port's recorded flops equal the reference's HLO dots."""
    sizes, M = (784, 200, 200), 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, sizes[0])).astype(np.float32)
    ws = [(rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32)
          for a, b in zip(sizes, sizes[1:])]
    bs = [np.zeros(b, np.float32) for b in sizes[1:]]

    def jloss(ws, bs, x):
        tot, h = 0.0, x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h, g = jops.ff_dense(h, w, b, impl="ref", norm=i == 0)
            tot = tot + jnp.sum(jax.nn.softplus(2.0 - g))
        return tot

    def tgrads(ws, bs, x):
        tot, h = 0.0, x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h, g = tops.ff_dense(h, w, b, impl="ref", norm=i == 0)
            tot = tot + torch.sum(torch.nn.functional.softplus(2.0 - g))
        return torch.autograd.grad(tot, ws + bs)

    want = _hlo(jax.grad(jloss, argnums=(0, 1)), ws, bs, x)["flops"]
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    tb = [torch.tensor(b, requires_grad=True) for b in bs]
    got = op_analysis.analyze(tgrads, tw, tb, torch.tensor(x))["flops"]
    assert got == want == 2 * M * (784 * 200 * 2 + 200 * 200 * 3)


# reduced prefill at (2, 64): the port's recorded flops over the
# reference's HLO dots. 1 where the programs do the same products (every
# decoder-only family: 1.0 at qwen2-0.5b, mamba2-780m, deepseek-moe-16b
# and recurrentgemma-2b when measured). The encoder-decoder and vision
# configs' port prefill projects each cross block's K and V twice (for
# the cross attention, and again in precompute_cross_kv for the decode
# cache), where XLA merges the reference's two identical projections:
# 2 * B * T * d * (2 * KV * hd) more, 8,388,608 flops at seamless (T 16
# frames; ratio 1.0319) and 4,194,304 at llama-vision (T 8 patches;
# 1.0050).
PREFILL_RATIO = {"qwen2-0.5b": 1.0,
                 "seamless-m4t-large-v2": 271581184 / 263192576}


@pytest.mark.parametrize("arch", sorted(PREFILL_RATIO))
def test_reduced_prefill_flops_against_the_reference(arch):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    B, S = 2, 64
    p = jax.eval_shape(lambda k: jtr.init(k, jc), jax.random.PRNGKey(0))
    sd = jax.ShapeDtypeStruct
    ash = jspecs.aux_shape(jc, B)
    aux = sd(ash, jnp.float32) if ash else None
    want = _hlo(lambda p, t, a: jtr.prefill(p, jc, t, aux=a,
                                            last_only=True),
                p, sd((B, S), jnp.int32), aux)["flops"]
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=S,
                                global_batch=B)
    _, got, _ = dryrun.trace_combo(tc, shape)
    assert got["flops"] / want == PREFILL_RATIO[arch]
    cross = 0
    if tc.enc_dec or tc.vision_tokens:
        cross = 2 * B * ttr.aux_tokens(tc) * tc.d_model * (
            2 * tc.n_kv * tc.resolved_head_dim)
    assert got["flops"] - want == cross


# ---------------------------------------------------------------------------
# Stand-ins against the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------

def _paths(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, path + (i,))]
    return [(path, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _same(fake_tree, sds_tree):
    """Every stand-in is fake and has its SDS's shape and dtype; the
    trees have the same leaves."""
    leaves = _paths(fake_tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(sds_tree))
    for path, t in leaves:
        s = _at(sds_tree, path)
        assert isinstance(t, FakeTensor), path
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).replace("torch.", "") == str(s.dtype), path


@pytest.fixture(scope="module")
def fake_params():
    """Each full config's stand-in params, made once (fake: no storage)."""
    return {arch: specs.param_specs_abstract(tget(arch), with_opt=False)[0]
            for arch in list_configs()}


@pytest.mark.parametrize("arch", list_configs())
def test_stand_ins_equal_the_reference_for_every_input_shape(arch,
                                                             fake_params):
    jc, tc = jget(arch), tget(arch)
    p_sds, _ = jspecs.param_specs_abstract(jc, None, with_opt=False)
    _same(fake_params[arch], p_sds)
    for name, shape in INPUT_SHAPES.items():
        assert specs.combo_is_applicable(tc, name) \
            == jspecs.combo_is_applicable(jc, name)
        jshape = J_SHAPES[name]
        mode = specs.new_mode()
        _same(specs.train_input_specs(tc, shape, mode=mode),
              jspecs.train_input_specs(jc, jshape))
        _same(specs.prefill_input_specs(tc, shape, mode=mode),
              jspecs.prefill_input_specs(jc, jshape))
        caches, tokens, pos = specs.decode_input_specs(tc, shape, mode=mode)
        j_caches, j_tokens, _ = jspecs.decode_input_specs(jc, jshape)
        _same((caches, tokens), (j_caches, j_tokens))
        assert pos == shape.seq_len - 1


def test_adam_state_stand_ins_are_f32_zeros_of_the_params_shapes():
    cfg = tget("qwen2-0.5b").reduced()
    params, opt = specs.param_specs_abstract(cfg)
    p_sds, o_sds = jspecs.param_specs_abstract(jget("qwen2-0.5b").reduced(),
                                               None)
    _same(params, p_sds)
    _same(opt, o_sds)
    assert all(t.dtype == torch.float32 for t in tree_leaves(opt))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
def test_spec_trees_under_a_mesh_equal_repro_sharding(arch, mesh_name):
    """The specs the reference's ``_sds`` attaches: ``_fit`` of
    ``data_spec`` for inputs, ``cache_specs_tree`` (the sequence axis
    on 'model' at batch 1) for caches, ``param_specs`` for params and
    Adam; and ``local=True`` stand-ins of rank 0's shard shape."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    mesh = specs.SizesMesh(specs.PRODUCTION_MESHES[mesh_name])
    mode = specs.new_mode()
    for B in (32, 1):
        shape = dataclasses.replace(
            INPUT_SHAPES["decode_32k"], seq_len=64, global_batch=B)
        batch, b_specs = specs.prefill_input_specs(tc, shape, mesh,
                                                   mode=mode)
        for k, t in batch.items():
            want = jsh._fit(jsh.data_spec(mesh, t.dim()), tuple(t.shape),
                            mesh)
            assert b_specs[k] == tuple(want), (B, k)
        (caches, tokens, _), (c_specs, t_spec, _) = \
            specs.decode_input_specs(tc, shape, mesh, mode=mode)
        want = jsh.cache_specs_tree(jtr.cache_specs(jc, B, 64), mesh,
                                    seq_axis_model=(B == 1))
        for path, _ in _paths(caches):
            assert _at(c_specs, path) == tuple(_at(want, path)), (B, path)
        assert t_spec == tuple(jsh._fit(jsh.data_spec(mesh, 1), (B,), mesh))
    (params, opt), (p_specs, o_specs) = specs.param_specs_abstract(
        tc, mesh, mode=mode)
    shapes = jax.eval_shape(lambda k: jtr.init(k, jc), jax.random.PRNGKey(0))
    want = jsh.param_specs(shapes, mesh)
    for path, t in _paths(params):
        assert _at(p_specs, path) == tuple(_at(want, path)), path
        assert _at(o_specs["m"], path) == _at(p_specs, path)
    (lp, lo), _ = specs.param_specs_abstract(tc, mesh, mode=mode,
                                             local=True)
    for path, t in _paths(params):
        spec = _at(p_specs, path)
        local = _at(lp, path)
        for dim, entry in enumerate(spec):
            n = 1
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n *= mesh.shape[ax] if ax else 1
            assert local.shape[dim] * n == t.shape[dim], (path, dim)
        assert isinstance(local, FakeTensor)
        assert _at(lo["v"], path).shape == local.shape


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

# one reduced config of each family, each tracing one step kind, so that
# every kind and family is traced
TRACES = [("qwen2-0.5b", "train"), ("deepseek-moe-16b", "prefill"),
          ("mamba2-780m", "decode"), ("recurrentgemma-2b", "decode"),
          ("seamless-m4t-large-v2", "train"),
          ("llama-3.2-vision-90b", "prefill")]


@pytest.mark.parametrize("arch,kind", TRACES)
def test_reduced_config_traces_with_fake_outputs(arch, kind):
    cfg = tget(arch).reduced()
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    shape = dataclasses.replace(INPUT_SHAPES[name], seq_len=32,
                                global_batch=2)
    out, an, meta = dryrun.trace_combo(cfg, shape,
                                       mesh=specs.SizesMesh({"data": 2,
                                                             "model": 2}))
    leaves = tree_leaves(out)
    assert leaves and all(isinstance(t, FakeTensor) for t in leaves
                          if isinstance(t, torch.Tensor))
    assert meta["kind"] == kind and meta["chips"] == 4
    assert meta["rank"] == 0 and meta["opts"] == []
    mem = an["memory"]
    assert an["flops"] > 0 and an["bytes"] > 0
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    # the rank holds its params (and Adam state) as the reference's rules
    # split them, and every other argument too: its rows of the train
    # batch, its blocks of the caches (an SSM state's hd over "model")
    assert mem["rank_param_bytes"] == mem["rules_param_bytes"] > 0
    assert 0 < mem["per_device_argument_bytes"] \
        == mem["rank_argument_bytes"] == mem["argument_size_in_bytes"]
    # every config splits some leaf over (2, 2) (embed at least): each
    # step gathers it, and the train step sums its grads too
    assert an["collective_bytes"] > 0
    assert an["collective_by_type"]["all-gather"] > 0
    assert an["collective_bytes"] == sum(an["collective_by_type"].values())


def test_a_trace_leaves_no_fake_tensor_behind():
    """The model caches device constants (rope's frequencies); one made
    during a fake trace must not stand in for the real one afterwards."""
    cfg = tget("qwen2-0.5b").reduced()
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=16,
                                global_batch=2)
    dryrun.trace_combo(cfg, shape)
    params = ttr.init(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    logits, _ = ttr.prefill(params, cfg, tokens, last_only=True,
                            impl="ref")
    assert type(logits) is torch.Tensor
    assert bool(torch.isfinite(logits).all())


def test_analyze_combo_keys_and_terms(monkeypatch):
    """qwen2-0.5b's decode_32k on the pod1 mesh, at the reduced config
    (the full one is --all's)."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: tget(a).reduced())
    res = dryrun.analyze_combo("qwen2-0.5b", "decode_32k", mesh="pod1")
    for k in ("model_flops", "compute_term_s", "memory_term_s",
              "collective_term_s", "flops_utilization", "bottleneck",
              "memory", "chips", "mesh"):
        assert k in res
    assert res["chips"] == 256 and res["per_device"] == "rank"
    assert res["rank"] == 0 and res["opts"] == []
    # dense decode gathers the leaves a rank holds split (embed, lm_head,
    # d_model over "data"), and sums its heads' and ff's parts over
    # "model"
    assert res["collective_term_s"] > 0.0
    assert res["collective_by_type"]["all-gather"] > 0
    assert res["collective_by_type"]["all-reduce"] > 0
    # every term the rank's own, as the reference's per-device program's
    assert res["compute_term_s"] == res["op_flops_total"] \
        / dryrun.PEAK_FLOPS
    assert res["memory_term_s"] == res["op_bytes_total"] / dryrun.HBM_BW
    assert res["flops_utilization"] == res["model_flops"] / (
        res["op_flops_total"] * 256)
    assert res["fits_hbm"]
    assert res["bottleneck"] == "memory"       # one token per sequence
    assert res["params"] == ttr.param_count(
        specs.param_specs_abstract(tget("qwen2-0.5b").reduced())[0])
    with pytest.raises(ValueError, match="inapplicable"):
        dryrun.analyze_combo("qwen2-0.5b", "long_500k")


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's dryrun module, imported after JAX's backend is up:
    its import writes a 512-device XLA_FLAGS into os.environ, which
    monkeypatch takes back (a later subprocess on this worker would
    inherit it)."""
    jax.devices()
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as jdry
    return jdry


def test_model_flops_equal_the_reference_for_every_combo(jdryrun,
                                                         fake_params):
    n = 0
    for arch in list_configs():
        jc, tc = jget(arch), tget(arch)
        total = ttr.param_count(fake_params[arch])
        for name, shape in INPUT_SHAPES.items():
            if not specs.combo_is_applicable(tc, name):
                continue
            want = jdryrun.model_flops(jc, J_SHAPES[name], shape.kind)
            assert dryrun.model_flops(tc, shape, shape.kind,
                                      total=total) == want, (arch, name)
            n += 1
    assert n == len(dryrun.all_combos()) == 33
