"""Logical-to-mesh sharding rules (the port of ``repro.sharding``), and
the per-rank collectives that take the place of ``shard_map``'s.

Single-pod production mesh: ``(data=16, model=16)``. Multi-pod:
``(pod=2, data=16, model=16)``: the batch shards on ``(pod, data)`` and
parameters exactly as single-pod (replicated over ``pod``). The PFF pod
mode instead uses a ``stage`` axis as the pipeline-stage axis
(``core.pff_pod``).

Parameter rules are name-based over the tree path, with a divisibility
guard: a mesh axis that does not divide its dim is dropped (the dim is
replicated), so every config gets a spec (KV = 4 heads cannot shard over
model = 16; h2o-danube's head_dim 120 cannot either).

Conventions (a group's leading ``R`` axis, the stacked units, is never
sharded):
  embed (V, d)            -> (model, data)        vocab-parallel + FSDP
  lm_head (d, V)          -> (data, model)
  attn wq (R, d, H, hd)   -> (-, data, model, -)  head-parallel + FSDP
  attn wk/wv (R, d,KV,hd) -> (-, data, model, -)
  attn wo (R, H, hd, d)   -> (-, model, -, data)
  mlp wi/wg (R, d, ff)    -> (-, data, model)
  mlp wo (R, ff, d)       -> (-, model, data)
  moe wi/wg (R, E, d, ff) -> (-, model, data, -)  expert-parallel + ZeRO
  moe wo (R, E, ff, d)    -> (-, model, -, data)
  ssm/rglru projections   -> (-, data, model) ; out_proj (-, model, data)
  norms / scalars         -> replicated

A spec is a tuple with one entry per dim of the ``PartitionSpec``'s:
``None``, an axis name, or a tuple of names (the dim split over their
product, the first name major). ``param_specs`` returns the params' tree
with a spec in place of each tensor.

Torch has no GSPMD: nothing compiles a global program from specs, so
the reference's ``shard_map`` and ``shardings()`` have no counterpart.
Each rank runs the per-rank body itself on its own block of a tensor
(``local_shard``, what a ``shard_map`` in_spec does to an argument) and
calls the collectives below on the mesh's axis groups: ``all_reduce``
for ``psum``/``pmean``, ``all_gather_into_tensor`` for ``all_gather``,
``all_to_all_single`` for ``all_to_all``, ``batch_isend_irecv`` for
``ppermute``; each but the last is an autograd Function with its
transpose as its backward (below). A rank's params are the blocks these
rules give it (``models.transformer.held_specs``); what GSPMD does with
such blocks, the rank does itself: ``gather_for_use`` makes a leaf
whole where it is read, the tensor-parallel blocks sum their parts
with ``psum``, a softmax over a split dim combines the ranks' parts
(``logsumexp``, ``softmax_combine``, over ``pmax``), and a decode
cache is the rank's block of ``cache_specs_tree``'s spec. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``, or, where no collective
runs (the rules, ``local_shard`` given its coordinates), any object
with a ``.shape`` mapping of axis sizes. On an axis of size 1 no
collective is called: each one is the identity there, and a
point-to-point send to itself is not.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.convert import tree_map


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def _is_device_mesh(mesh):
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def axis_names(mesh):
    """The mesh's axis names, in order."""
    if _is_device_mesh(mesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh):
    """{axis name: size} of a ``DeviceMesh`` or of any object with a
    ``.shape`` mapping; ``{}`` for ``None`` (one process, no mesh)."""
    if mesh is None:
        return {}
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, axis):
    """The size of ``axis`` (1 for an axis the mesh does not have)."""
    return axis_sizes(mesh).get(axis, 1)


def axis_index(mesh, axis):
    """This process's coordinate along ``axis`` (0 on a size-1 axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis):
    """The process group of ``axis`` through this process, or ``None``
    on a size-1 axis, where no collective runs."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def _names(entry):
    return entry if isinstance(entry, tuple) else (entry,)


def _fit(spec, shape, mesh):
    """Drop axis names that don't divide the dim; None-pad to rank."""
    sizes = axis_sizes(mesh)
    names = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, name in zip(shape, names):
        if name is None:
            out.append(None)
            continue
        size = math.prod(sizes[n] for n in _names(name))
        out.append(name if dim % size == 0 else None)
    return tuple(out)


# desired spec by the path's first key; checked before the group rules
_RULES = [
    ("embed",      lambda: ("model", "data")),
    ("lm_head",    lambda: ("data", "model")),
    ("final_norm", lambda: (None,)),
    ("enc_norm",   lambda: (None,)),
]

_GROUP_LEAF = {
    "wq":       (None, "data", "model", None),
    "wk":       (None, "data", "model", None),
    "wv":       (None, "data", "model", None),
    "wo":       None,   # context-dependent: attn (R,H,hd,d) vs mlp (R,ff,d)
    "wi":       None,   # mlp (R,d,ff) vs moe (R,E,d,ff)
    "wg":       None,
    "bq":       (None, "model", None),
    "bk":       (None, "model", None),
    "bv":       (None, "model", None),
    "q_norm":   (None, None),
    "k_norm":   (None, None),
    "gate":     (None,),
    "router":   (None, None, None),
    "in_proj":  (None, "data", "model"),
    "conv_w":   (None, None, "model"),
    "A_log":    (None, None),
    "D":        (None, None),
    "dt_bias":  (None, None),
    "norm":     (None, "model"),
    "out_proj": (None, "model", "data"),
    "x_branch": (None, "data", "model"),
    "gate_branch": (None, "data", "model"),
    "w_a":      (None, "data", "model"),
    "w_x":      (None, "data", "model"),
    "lambda":   (None, "model"),
    "norm1":    (None, None),
    "norm2":    (None, None),
    "norm_x":   (None, None),
}


def _leaf_spec(path_names, shape):
    name = path_names[-1]
    if name in ("wi", "wg"):
        if len(shape) == 4:                       # moe (R, E, d, ff)
            return (None, "model", "data", None)
        return (None, "data", "model")            # dense (R, d, ff)
    if name == "wo":
        if len(shape) == 4:                       # attn (R, H, hd, d) and
            return (None, "model", None, "data")  # moe (R, E, ff, d) alike
        return (None, "model", "data")            # mlp (R, ff, d)
    if name in _GROUP_LEAF and _GROUP_LEAF[name] is not None:
        return _GROUP_LEAF[name]
    return tuple(None for _ in shape)


def map_with_path(fn, tree, path=()):
    """``fn(path names, leaf)`` over a tree of dicts, lists and tuples
    (``None`` stays ``None``), keys and indices as strings."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_spec(names, shape, mesh):
    """The spec of one leaf of a params tree by its path ``names`` (from
    the tree's root: a group leaf's path starts with "groups" and its
    shape with the stacked ``R`` axis) and its shape."""
    shape = tuple(shape)
    for key, make_spec in _RULES:
        if names and names[0] == key:
            return _fit(make_spec(), shape, mesh)
    return _fit(_leaf_spec(names, shape), shape, mesh)


def unit_spec(names, shape, mesh):
    """The spec of a leaf of one unit's views (a stacked group's layer
    ``r``, no ``R`` axis; ``names`` from the unit's root): the stacked
    leaf's spec with its leading ``R`` entry dropped."""
    return leaf_spec(("groups",) + tuple(names), (1,) + tuple(shape),
                     mesh)[1:]


def param_specs(params, mesh):
    """The params' tree with each tensor's spec in its place (Adam's m
    and v take the same)."""
    return map_with_path(lambda names, leaf: leaf_spec(names, leaf.shape,
                                                       mesh), params)


def batch_axes(mesh):
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_spec(mesh, rank, batch_dim=0):
    """Spec for a batch-dim-sharded tensor of the given rank."""
    ba = batch_axes(mesh)
    dims = [None] * rank
    dims[batch_dim] = ba if len(ba) > 1 else ba[0]
    return tuple(dims)


def cache_leaf_spec(shape, mesh, seq_axis_model=False):
    """The spec of one stacked decode-cache leaf of ``shape`` (``R, B,
    ...``), ``cache_specs_tree``'s rule for it."""
    shape = tuple(shape)
    if len(shape) < 3:
        return (None,) * len(shape)
    ba = batch_axes(mesh)
    want = [None, ba if len(ba) > 1 else ba[0]]
    if len(shape) == 5:                      # (R, B, S, KV, hd)
        want += ["model" if seq_axis_model else None,
                 None if seq_axis_model else "model", None]
    elif len(shape) == 4:                    # (R, B, H, ...) state
        want += ["model", None]
    else:
        want += [None] * (len(shape) - 2)
    return _fit(want[:len(shape)], shape, mesh)


def cache_specs_tree(caches, mesh, *, seq_axis_model=False):
    """Specs for decode caches.

    KV caches (R, B, S, KV, hd): batch -> data axes; with
    ``seq_axis_model`` S shards on 'model' (batch-1 long context, where
    the batch cannot use the data axis). SSM/RG-LRU states (R, B, ...):
    batch -> data, trailing dims on model where divisible (a 5-dim SSM
    state (R, B, H, hd, N) by the KV rule: hd on 'model', or H with
    ``seq_axis_model``). The one rule of which block of a cache a rank
    holds, in the dry run and at runtime (``blocks.cache_block``).
    """
    return map_with_path(
        lambda _, leaf: cache_leaf_spec(leaf.shape, mesh, seq_axis_model),
        caches)


def local_shard(t, spec, mesh, coords=None):
    """This rank's block of the full tensor ``t`` under ``spec`` (a view):
    what a ``shard_map`` in_spec gives the body. ``coords`` ({axis:
    index}) names another rank's block; by default this process's
    coordinates in ``mesh``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for name in _names(entry):
            c = (coords[name] if coords is not None
                 else axis_index(mesh, name))
            size = axis_size(mesh, name)
            idx, n = idx * size + c, n * size
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split over {entry} ({n} ways)")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t


# ---------------------------------------------------------------------------
# Collectives over one mesh axis (each the identity on a size-1 axis)
#
# Each is an autograd Function whose backward is its forward's transpose,
# as the reference's ``shard_map`` differentiates its collectives, and
# none modifies its input. Under the per-rank convention of the train
# steps (each rank's loss is its rows' part of the global loss, and a
# value every rank of an axis computes alike is a replica, not a sum), the
# transposes are:
#   psum        of partial sums whose result every rank uses alike: the
#               identity (each rank's cotangent is the whole one);
#   pmean       1/n of the cotangent;
#   all_gather  a reduce-scatter (sum) of the cotangent;
#   all_to_all  the inverse exchange (the same exchange again);
#   pvary       (a replica entering per-rank work, forward the identity)
#               the sum of the cotangents over the axis;
#   pmean_equal (the mean of values already equal over the axis, forward
#               the identity) 1/n of the cotangent;
#   gather_for_use (a held block gathered whole for work every rank runs
#               alike) over a batch axis a reduce-scatter, over any other
#               axis the rank's own block of the cotangent.
# ---------------------------------------------------------------------------

def _gather_single():
    # the *_single names replace the *_tensor ones in newer torch
    return (getattr(dist, "all_gather_single", None)
            or dist.all_gather_into_tensor)


def _scatter_single():
    return (getattr(dist, "reduce_scatter_single", None)
            or dist.reduce_scatter_tensor)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n):
        ctx.n = n
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out.div_(n)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        part = t.movedim(dim, 0).contiguous()
        out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
        _gather_single()(out, part, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        full = g.movedim(ctx.dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // ctx.n,)
                             + tuple(full.shape[1:]))
        _scatter_single()(out, full, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def _exchange(t, group):
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _GatherOwn(torch.autograd.Function):
    """``all_gather`` forward; backward the rank's own block of the
    cotangent, with no sum: the ranks of the axis hold the same rows and
    compute alike on the gathered tensor, so each one's cotangent is
    already the whole one."""

    @staticmethod
    def forward(ctx, t, group, n, dim, index):
        ctx.dim, ctx.index, ctx.step = dim, index, t.shape[dim]
        return _AllGather.forward(ctx, t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.step, ctx.step),
                None, None, None, None)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


class _PMeanEqual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum(t, mesh, axis):
    """Sum of ``t`` over ``axis`` (``lax.psum``), a new tensor."""
    group = axis_group(mesh, axis)
    return t if group is None else _PSum.apply(t, group)


def pmean(t, mesh, axis):
    """Mean of ``t`` over ``axis``, in ``t``'s dtype (``lax.pmean``: the
    sum, then divided by the axis size), a new tensor."""
    group = axis_group(mesh, axis)
    if group is None:
        return t
    return _PMean.apply(t, group, axis_size(mesh, axis))


def all_gather(t, mesh, axis, dim=0):
    """The blocks of ``t`` over ``axis`` concatenated on ``dim`` in rank
    order (``lax.all_gather(tiled=True)``)."""
    group = axis_group(mesh, axis)
    if group is None:
        return t
    return _AllGather.apply(t, group, axis_size(mesh, axis), dim)


def gather_for_use(t, spec, mesh, batch_axes):
    """The whole tensor from every rank's block of ``t`` under ``spec``
    (``gather_tree``'s gather, one leaf), for work that every rank runs
    on the whole leaf. Its backward hands each rank its block of the
    cotangent: over an axis of ``batch_axes``, whose ranks hold
    different rows, the ranks' cotangents summed (a reduce-scatter);
    over any other axis, whose ranks hold the same rows and so compute
    the same cotangent, the rank's own block with no sum. The batch axes
    gather first, so that their reduce-scatters run last in the
    backward, on the rank's block of every other axis (a dim split over
    several axes takes them all of one kind)."""
    for e in spec:
        if e is not None and len({a in batch_axes for a in _names(e)}) > 1:
            raise ValueError(f"{e} mixes batch and other axes on one dim")
    for batch in (True, False):
        for dim, entry in enumerate(spec):
            for a in reversed(_names(entry) if entry is not None else ()):
                group = axis_group(mesh, a)
                if group is None or (a in batch_axes) != batch:
                    continue
                if batch:
                    t = _AllGather.apply(t, group, axis_size(mesh, a), dim)
                else:
                    t = _GatherOwn.apply(t, group, axis_size(mesh, a), dim,
                                         axis_index(mesh, a))
    return t


def all_to_all(t, mesh, axis):
    """``t``'s leading dim (one block per rank of ``axis``) exchanged:
    block i goes to rank i, and block j of the result came from rank j
    (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    group = axis_group(mesh, axis)
    return t if group is None else _AllToAll.apply(t, group)


def pvary(t, mesh, axis):
    """``t``, a value every rank of ``axis`` holds alike, as the input of
    work that differs by rank (``lax.pvary``): the identity forward; its
    cotangents summed over ``axis`` backward."""
    group = axis_group(mesh, axis)
    return t if group is None else _PVary.apply(t, group)


def pmean_equal(t, mesh, axis):
    """The mean over ``axis`` of a value that every rank of it already
    holds alike: ``t`` itself forward (no collective), pmean's transpose
    (the cotangent over the axis size) backward."""
    n = axis_size(mesh, axis)
    return t if n == 1 else _PMeanEqual.apply(t, n)


def pmax(t, mesh, axis):
    """The elementwise max of ``t`` over ``axis`` (``lax.pmax``), a new
    tensor with no gradient: the shift of a softmax, whose value
    cancels."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    group = axis_group(mesh, axis)
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def logsumexp(x, mesh, axis, dim=-1):
    """``log(sum(exp(x)))`` over ``dim``, whose entries are split over
    ``axis`` (each rank holds its block of them): the max all-reduced
    (``pmax``), then the ranks' sums of ``exp(x - max)`` added
    (``psum``: the ranks of ``axis`` compute the result alike, so each
    one's cotangent passes through whole and reaches its block)."""
    m = pmax(x.amax(dim), mesh, axis)
    s = psum(torch.exp(x - m.unsqueeze(dim)).sum(dim), mesh, axis)
    return m + torch.log(s)


def softmax_combine(m, l, o, mesh, axis):
    """A softmax-weighted sum whose keys are split over ``axis``, from
    each rank's part over its keys: ``m`` the max of its scores, ``l``
    the sum of ``exp(score - m)``, ``o`` the values weighted by those
    (one trailing dim more than ``m`` and ``l``). Each part is rescaled
    to the all-reduced max and the parts summed (``psum``): ``o / l``.
    Forward only (decode)."""
    M = pmax(m, mesh, axis)
    scale = torch.exp(m - M)
    lsum = psum(l * scale, mesh, axis)
    osum = psum(o * scale.unsqueeze(-1), mesh, axis)
    return osum / lsum.unsqueeze(-1)


# ---------------------------------------------------------------------------
# The batch over several axes, and trees of shards
# ---------------------------------------------------------------------------

def axes_size(mesh, axes):
    """The product of the sizes of ``axes``."""
    return math.prod(axis_size(mesh, a) for a in axes)


def axes_index(mesh, axes):
    """This process's block index over ``axes``, the first major."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def block_of(t, mesh, axes, dim=0):
    """This rank's contiguous block of ``t``'s ``dim`` split over
    ``axes`` (the first major): what an in_spec ``P(axes)`` gives."""
    if not axes:
        return t
    spec = [None] * t.dim()
    spec[dim] = tuple(axes)
    return local_shard(t, spec, mesh)


def gather_blocks(t, mesh, axes, dim=0):
    """The blocks of ``t`` over ``axes`` concatenated on ``dim`` in block
    order (``block_of``'s inverse)."""
    for a in reversed(tuple(axes)):
        t = all_gather(t, mesh, a, dim)
    return t


def rank_of_block(mesh, axes, index):
    """The global rank of the process whose block index over ``axes``
    (the first major) is ``index`` and whose coordinates on every other
    axis are this process's (read off the mesh's table of ranks outside
    any dispatch mode the caller runs under, as the dry run's)."""
    from torch.utils._python_dispatch import _disable_current_modes

    coords = list(mesh.get_coordinate())
    names = axis_names(mesh)
    for a in reversed(tuple(axes)):
        size = axis_size(mesh, a)
        if a in names:
            coords[names.index(a)] = index % size
        index //= size
    with _disable_current_modes():
        return int(mesh.mesh[tuple(coords)])


def stacked_block(t, mesh, axes, copies):
    """This rank's block of ``cat([whole] * copies)`` over ``axes``,
    where ``t`` is its block of ``whole``'s rows (``block_of``): each
    row sent point to point from the rank that holds it, so that no rank
    holds ``whole``. Each pair of ranks exchanges at most one run of
    rows (``copies`` is at most the number of blocks; with one block
    the rank's rows are ``whole``). No gradient."""
    n, me = axes_size(mesh, axes), axes_index(mesh, axes)
    if n == 1:
        return torch.cat([t] * copies)
    if copies > n:
        raise ValueError(f"{copies} copies over {n} blocks")
    b = t.shape[0]

    def runs(d):
        """The rows of block ``d`` of the stack: (source block, first
        row there, count) in order."""
        out, j, end = [], d * copies * b, (d + 1) * copies * b
        while j < end:
            src, r0 = divmod(j % (n * b), b)
            k = min(b - r0, end - j)
            out.append((src, r0, k))
            j += k
        return out

    t = t.detach().contiguous()
    parts, ops = [], []
    for src, r0, k in runs(me):
        if src == me:
            parts.append(t[r0:r0 + k])
        else:
            buf = t.new_empty((k,) + tuple(t.shape[1:]))
            ops.append(dist.P2POp(dist.irecv, buf,
                                  rank_of_block(mesh, axes, src)))
            parts.append(buf)
    for d in range(n):
        if d != me:
            for src, r0, k in runs(d):
                if src == me:
                    ops.append(dist.P2POp(dist.isend, t[r0:r0 + k],
                                          rank_of_block(mesh, axes, d)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat(parts)


def sum_in_rank_order(x, mesh, axes):
    """Sums over ``axes`` of the 0-d or 1-d tensor ``x``: the ranks'
    values gathered and reduced in block order, so that every rank gets
    the same bits."""
    vals = gather_blocks(x.reshape(1, -1), mesh, axes)
    return vals.sum(0).reshape(x.shape)


def sum_grads(grads, specs, mesh, axes):
    """Each grad summed over those of ``axes`` its spec does not name
    (the leaf is replicated over them, each rank holding its rows' part),
    one ``all_reduce`` per (axes, dtype) bucket; ``specs`` in ``grads``'s
    order. A new list."""
    out = list(grads)
    buckets = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        named = {n for e in spec if e is not None for n in _names(e)}
        over = tuple(a for a in axes if a not in named
                     and axis_size(mesh, a) > 1)
        if over:
            buckets.setdefault((over, g.dtype), []).append(i)
    for (over, _), idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for a in over:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                            group=axis_group(mesh, a))
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def shard_tree(tree, specs, mesh):
    """This rank's blocks of every leaf of ``tree`` under ``specs`` (one
    per leaf, in ``tree_leaves`` order): copies where a spec splits the
    leaf, so nothing keeps the whole tensor alive; the leaf itself
    where it is held whole."""
    it = iter(specs)

    def one(t):
        spec = next(it)
        if all(e is None for e in spec):
            return t
        return local_shard(t, spec, mesh).clone()

    return tree_map(one, tree)


def gather_tree(tree, specs, mesh):
    """The whole leaves from every rank's blocks (``shard_tree``'s
    inverse; a collective per split dim, every rank calls it)."""
    it = iter(specs)

    def one(t):
        for dim, entry in enumerate(next(it)):
            if entry is not None:
                t = gather_blocks(t, mesh, _names(entry), dim)
        return t

    return tree_map(one, tree)


def shift(t, mesh, axis):
    """``t`` sent to the next rank of ``axis`` (wrapping round) and the
    previous rank's received in its place (``lax.ppermute`` by +1). On a
    size-1 axis ``t`` itself comes back: nothing is sent."""
    group = axis_group(mesh, axis)
    if group is None:
        return t
    return ring_shift(t, group)


def ring_shift(t, group):
    """``shift`` over a process group: to group rank i + 1, from i - 1,
    translated to global ranks for the point-to-point ops."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, nxt, group),
        dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return out
