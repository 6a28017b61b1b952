"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro.sharding``, with no process group: ``param_specs``
entry for entry for all 10 configs at their published sizes (shapes
from the reference's ``jax.eval_shape``, the port's tree of ``meta``
tensors) on the single-pod and multi-pod meshes, ``batch_axes``,
``data_spec`` and ``cache_specs_tree``; ``local_shard`` round-trips;
and the mesh constructors refuse to run without a group of the right
size."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import sharding as jsh
from repro.configs import get_config as jget, list_configs
from repro.models import transformer as jtr
from repro_torch import sharding as tsh
from repro_torch.configs import get_config as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttr


class FakeMesh:
    """A mesh of axis sizes only, as ``tests/test_substrate.py``'s."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"pod1": FakeMesh({"data": 16, "model": 16}),
          "pod2": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _leaves_with_paths(tree, path=()):
    """(path, leaf) of a tree of dicts and tuples; None is empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_with_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _meta(shapes):
    """The reference's ShapeDtypeStruct tree as ``meta`` tensors."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_equal_the_reference(arch):
    cfg = jget(arch)
    shapes = jax.eval_shape(lambda k: jtr.init(k, cfg),
                            jax.random.PRNGKey(0))
    params = _meta(shapes)
    n = 0
    for name, mesh in MESHES.items():
        want = jsh.param_specs(shapes, mesh)
        got = tsh.param_specs(params, mesh)
        for path, leaf in _leaves_with_paths(params):
            spec = _at(got, path)
            assert spec == tuple(_at(want, path)), (name, path)
            assert len(spec) == leaf.dim()
            n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("seq_axis_model", [False, True])
def test_cache_specs_tree_equals_the_reference(arch, seq_axis_model):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    shapes = jtr.cache_specs(jc, 32, 64)
    caches = ttr.init_caches(tc, 32, 64, device="meta")
    for name, mesh in MESHES.items():
        want = jsh.cache_specs_tree(shapes, mesh,
                                    seq_axis_model=seq_axis_model)
        got = tsh.cache_specs_tree(caches, mesh,
                                   seq_axis_model=seq_axis_model)
        paths = _leaves_with_paths(caches)
        assert len(paths) == len(jax.tree_util.tree_leaves(shapes))
        for path, leaf in paths:
            assert tuple(leaf.shape) == _at(shapes, path).shape
            assert _at(got, path) == tuple(_at(want, path)), (name, path)


def test_batch_axes_and_data_spec_equal_the_reference():
    for mesh in MESHES.values():
        assert tsh.batch_axes(mesh) == jsh.batch_axes(mesh)
        for rank in (1, 2, 4):
            for dim in range(rank):
                assert tsh.data_spec(mesh, rank, dim) == \
                    tuple(jsh.data_spec(mesh, rank, dim))
    assert tsh.axis_sizes(MESHES["pod2"]) == {"pod": 2, "data": 16,
                                              "model": 16}
    assert tsh.axis_size(MESHES["pod1"], "stage") == 1
    assert tsh.axis_sizes(None) == {}


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  ("model", "data"), (("pod", "data"),),
                                  (("data", "pod"), "model")])
def test_local_shard_round_trips(spec):
    mesh = FakeMesh({"pod": 2, "data": 4, "model": 2})
    t = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    blocks = {}
    for p in range(2):
        for d in range(4):
            for m in range(2):
                c = {"pod": p, "data": d, "model": m}
                blocks[(p, d, m)] = tsh.local_shard(t, spec, mesh, coords=c)
    # put every block back where its coordinates say: t again
    back = torch.full_like(t, float("nan"))
    for (p, d, m), b in blocks.items():
        idx = []
        for dim, entry in enumerate(spec):
            if entry is None:
                idx.append(slice(None))
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            i, n = 0, 1
            for name in names:
                size = mesh.shape[name]
                i, n = i * size + {"pod": p, "data": d, "model": m}[name], \
                    n * size
            step = t.shape[dim] // n
            idx.append(slice(i * step, (i + 1) * step))
        back[tuple(idx)] = b
    assert torch.equal(back, t)
    # a block is a view of the full tensor, as a shard_map argument is
    assert blocks[(1, 3, 1)].data_ptr() >= t.data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_shard(torch.zeros(3, 3), spec, mesh,
                        coords={"pod": 0, "data": 0, "model": 0})


def test_meshes_need_a_group_of_their_size():
    assert not dist.is_initialized()
    for make in (lambda: tmesh.make_production_mesh(),
                 lambda: tmesh.make_production_mesh(multi_pod=True),
                 lambda: tmesh.make_pff_stage_mesh(stages=2),
                 lambda: tmesh.make_host_mesh(),
                 lambda: tmesh.make_mesh((1, 1, 1), ("stage", "data",
                                                     "model"))):
        with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
            make()
    assert not dist.is_initialized()          # nothing made a group
    np.testing.assert_equal(len(tmesh.pff_node_devices(3, "cpu")), 3)
