"""Fake-tensor input stand-ins for every (arch x input-shape) pair (the
port of ``repro.launch.specs``).

The reference lowers against ``jax.ShapeDtypeStruct``s. The port traces
against fake tensors (``torch._subclasses.fake_tensor``): each has a
shape, a dtype and a device but no storage, and every aten op on it runs
only its shape logic, so nothing here allocates memory. Stand-ins that
meet in one trace must come from one ``FakeTensorMode``: the caller
passes its ``mode`` (``new_mode()`` makes one), or each call makes its
own.

Torch tensors carry no sharding. With a ``mesh`` each function returns
``(stand-ins, specs)``: the tree of tuple specs from the port's
``sharding`` rules beside the tree of stand-ins, ``_fit``-ed to the
shapes as the reference's ``_sds`` does. ``local=True`` gives each
stand-in its rank-0 shard's shape instead of the global one
(``sharding.local_shard``'s arithmetic). A mesh is a ``DeviceMesh`` or a
sizes-only ``SizesMesh``; no process group is needed.

``decode_input_specs`` returns the decode position as a Python int (the
last slot of a ``seq_len``-deep cache): the port's ``serve_step`` takes
an int where the reference's takes an int32 scalar.

Those specs are the reference's rules (tensor-parallel dense weights),
which one rank of the port's ``Dist`` steps holds its params and Adam
state by too (``transformer.held_specs``; ``held_params``), beside the
rank's block of a batch (``batch_block``) and of the decode caches
(``cache_block``), for ``launch.dryrun``'s per-rank trace.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import optim, sharding
from repro_torch.configs.base import SUBQUADRATIC
from repro_torch.convert import tree_map
from repro_torch.models import common, transformer
from repro_torch.models.mlp import model_split


class SizesMesh:
    """A mesh of axis sizes only (``{"data": 16, "model": 16}``), for the
    rules and the dry run: no devices, no process group."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


# the reference's production meshes (``launch/mesh.py``), as sizes
PRODUCTION_MESHES = {"pod1": {"data": 16, "model": 16},
                     "pod2": {"pod": 2, "data": 16, "model": 16}}


def new_mode():
    """A ``FakeTensorMode`` for stand-ins and the traces that read them;
    real tensors made inside a traced step (constants) are let in."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake(mode, shape, dtype):
    with mode:
        return torch.empty(tuple(shape), dtype=dtype)


def _placed(mode, tree, specs, mesh, local):
    """``tree`` of stand-ins, each replaced by a fresh stand-in of its
    rank-0 shard's shape when ``local``."""
    if not local:
        return tree
    coords = {a: 0 for a in sharding.axis_names(mesh)}
    flat = leaves_with_specs(tree, specs)
    shards = {id(t): _fake(mode, sharding.local_shard(t, s, mesh,
                                                      coords).shape, t.dtype)
              for t, s in flat}
    return tree_map(lambda t: shards[id(t)], tree)


def leaves_with_specs(tree, specs):
    """(leaf, spec) pairs of a tree of stand-ins and its tree of specs
    (``None`` subtrees are empty)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in tree for p in leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for t, s in zip(tree, specs) for p in leaves_with_specs(t, s)]
    return [(tree, specs)]


def _result(mode, tree, specs, mesh, local):
    if mesh is None:
        return tree
    return _placed(mode, tree, specs, mesh, local), specs


def aux_shape(cfg, batch):
    """Stub-frontend embedding shape for audio/vlm archs (else None)."""
    if cfg.enc_dec:
        return (batch, cfg.enc_seq, cfg.d_model)
    if cfg.vision_tokens:
        return (batch, cfg.vision_tokens, cfg.vision_dim or cfg.d_model)
    return None


def _inputs(cfg, B, S, mesh, mode):
    """({tokens (B, S) int32, aux?}, their specs or None)."""
    out = {"tokens": _fake(mode, (B, S), torch.int32)}
    ash = aux_shape(cfg, B)
    if ash is not None:
        out["aux"] = _fake(mode, ash, common.dtype_of(cfg))
    if mesh is None:
        return out, None
    specs = {k: sharding._fit(sharding.data_spec(mesh, t.dim()), t.shape,
                              mesh)
             for k, t in out.items()}
    return out, specs


def train_input_specs(cfg, shape, mesh=None, *, mode=None, local=False):
    """The batch dict of the FF/BP train step: tokens (B, S+1) and the
    stub embeddings where the config reads them."""
    mode = mode or new_mode()
    batch, specs = _inputs(cfg, shape.global_batch, shape.seq_len + 1,
                           mesh, mode)
    return _result(mode, batch, specs, mesh, local)


def prefill_input_specs(cfg, shape, mesh=None, *, mode=None, local=False):
    """{tokens (B, S), aux?} of ``transformer.prefill``."""
    mode = mode or new_mode()
    batch, specs = _inputs(cfg, shape.global_batch, shape.seq_len, mesh,
                           mode)
    return _result(mode, batch, specs, mesh, local)


def decode_input_specs(cfg, shape, mesh=None, *, mode=None, local=False):
    """(caches, tokens (B,), pos) of ``serve_step`` with a seq_len-deep
    cache; pos = seq_len - 1, an int."""
    mode = mode or new_mode()
    B, S = shape.global_batch, shape.seq_len
    caches = tree_map(lambda t: _fake(mode, t.shape, t.dtype),
                      transformer.cache_specs(cfg, B, S))
    tokens = _fake(mode, (B,), torch.int32)
    out = (caches, tokens, S - 1)
    if mesh is None:
        return out
    specs = (sharding.cache_specs_tree(caches, mesh,
                                       seq_axis_model=(B == 1)),
             sharding._fit(sharding.data_spec(mesh, 1), (B,), mesh), ())
    placed = _placed(mode, (caches, tokens), specs[:2], mesh, local)
    return placed + (S - 1,), specs


def param_specs_abstract(cfg, mesh=None, with_opt=True, seed=0, *,
                         mode=None, local=False):
    """(params, Adam state or None) as stand-ins: the port's own
    ``transformer.init`` under the mode, and ``optim.adam_init``'s f32
    zeros, as the reference's are."""
    mode = mode or new_mode()
    with mode:
        params = transformer.init(torch.Generator().manual_seed(seed), cfg)
        opt = optim.adam_init(params) if with_opt else None
    if mesh is None:
        return params, opt
    pspecs = sharding.param_specs(params, mesh)
    specs = (pspecs, {"m": pspecs, "v": pspecs} if with_opt else None)
    return _placed(mode, (params, opt), specs, mesh, local), specs


def held_params(cfg, dist, with_opt=True, seed=0, *, mode=None,
                params=None):
    """(params, Adam state or None) as one rank of ``dist`` holds them in
    the port's ``Dist`` steps: each leaf a fresh stand-in of its block
    under ``transformer.held_specs`` (the reference's rules), and Adam's
    f32 zeros of those. ``dist.mesh`` is a ``DeviceMesh``: the block is
    this process's. ``params``: the whole params' stand-ins, if the
    caller has them (default: ``param_specs_abstract``'s)."""
    mode = mode or new_mode()
    if params is None:
        params, _ = param_specs_abstract(cfg, with_opt=False, seed=seed,
                                         mode=mode)
    it = iter(transformer.held_specs(params, cfg, dist))
    params = tree_map(lambda t: _fake(mode, sharding.local_shard(
        t, next(it), dist.mesh).shape, t.dtype), params)
    with mode:
        opt = optim.adam_init(params) if with_opt else None
    return params, opt


def batch_block(tree, dist, *, mode=None, exact=False):
    """``tree`` of stand-ins with each leaf's batch dim (0) cut to this
    rank's block over ``dist.batch_axes``, where their product divides
    it (``sharding._fit``'s rule; else the leaf stays whole, as at batch
    1). ``exact``: the block or ``ValueError`` (the train step's
    batch, which its ranks split by rows whatever the rules say)."""
    mode = mode or new_mode()
    mesh, axes = dist.mesh, tuple(dist.batch_axes)

    def one(path, t):
        spec = [None] * t.dim()
        spec[0] = axes
        if not exact:
            spec = sharding._fit(spec, t.shape, mesh)
            if all(e is None for e in spec):
                return t
        return _fake(mode, sharding.local_shard(t, spec, mesh).shape,
                     t.dtype)

    return sharding.map_with_path(one, tree)


def cache_block(caches, dist, *, mode=None, seq_axis_model=False):
    """Decode ``caches`` (stand-ins of the whole ones) as one rank of
    ``dist`` holds them, what ``transformer.prefill`` leaves it: each
    leaf its block of ``sharding.cache_specs_tree(seq_axis_model=)``'s
    spec where "model" splits work (``mlp.model_split``); else (the
    model axis folded into the batch) its block of the batch dim (1, of
    ``(R, B, ...)``) over the batch axes, every other dim whole."""
    mode = mode or new_mode()
    mesh = dist.mesh

    def one(path, t):
        if model_split(dist):
            spec = sharding.cache_leaf_spec(t.shape, mesh, seq_axis_model)
        elif t.dim() < 3:
            return t
        else:
            spec = [None] * t.dim()
            spec[1] = tuple(dist.batch_axes)
            spec = sharding._fit(spec, t.shape, mesh)
        if all(e is None for e in spec):
            return t
        return _fake(mode, sharding.local_shard(t, spec, mesh).shape,
                     t.dtype)

    return sharding.map_with_path(one, caches)


def combo_is_applicable(cfg, shape_name):
    """long_500k only for sub-quadratic sequence mixing."""
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False
    return True
