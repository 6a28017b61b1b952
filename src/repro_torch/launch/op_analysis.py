"""Roofline quantities of an eager PyTorch call, recorded op by op (the
port's counterpart of ``repro.launch.hlo_analysis``).

The reference reads them from the optimized HLO text of a compiled
program. Eager PyTorch has no HLO: ``analyze`` runs the call under a
``TorchDispatchMode`` and records every aten op it dispatches (with
fake tensors, nothing is computed or allocated; see ``launch.dryrun``):

  flops        2*M*N*K of every matmul-class op (``mm``, ``addmm``,
               ``bmm``, ``baddbmm``, convolutions, the SDPA ops), by
               ``torch.utils.flop_counter``'s formulas. Elementwise work
               is ignored, as in the reference.
  bytes        eager PyTorch's device-memory traffic, since nothing
               fuses: each op's input bytes plus output bytes. An op
               whose output shares the storage of an input without
               writing it (a view, ``_unsafe_view``, ``detach``) counts
               0, as do allocations (``empty``) and ops that return no
               tensor (``prim::device``); an in-place write of an
               update into a tensor (``copy_``, ``index_copy_``,
               ``index_put_``) counts 2x the update (read it, write it),
               the reference's ``dynamic-update-slice`` rule; any other
               in-place op counts its inputs plus the tensor it writes.
  collectives  the c10d ops by the reference's five types, their result
               bytes and counts; a point-to-point send counts as
               ``collective-permute`` (its receive is not counted again).
  memory       the counterpart of ``compiled.memory_analysis()``: the
               bytes of the arguments' storages, the peak of live bytes
               (the arguments plus every storage an op created that is
               still alive, each released by a ``weakref.finalize`` when
               its storage dies), temp = peak - arguments, and the
               output bytes the call returns that it created.

Loops are Python loops, unrolled as the call runs, so every count is
exact by construction: the reference needed ``_trip_count`` to weight
while-loop bodies.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d and functional-collective op names -> the reference's types
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
}
# in-place writes of an update into (a region of) a tensor, by the
# position of the update among the op's arguments: 2x the update
_SCATTER = {"copy_": 1, "index_copy_": 3, "index_put_": 2,
            "_index_put_impl_": 2}
# allocations: no traffic
_ALLOC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
          "empty_like"}


def _tensors(tree):
    """The tensors in a (nested) tuple / list / dict of op arguments."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t):
    return t.numel() * t.element_size()


class OpRecorder(TorchDispatchMode):
    """Counts flops, bytes, collectives and live storage bytes of every
    aten op dispatched while it is active."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_by_type = {c: 0 for c in COLLECTIVES}
        self.collective_counts = {c: 0 for c in COLLECTIVES}
        self._args = {}                  # id(storage) -> bytes
        for t in _tensors(args):
            st = t.untyped_storage()
            self._args[id(st)] = st.nbytes()
        self.argument_bytes = sum(self._args.values())
        self._live = {}                  # id(storage) -> bytes, made here
        self.live = self.argument_bytes
        self.peak = self.live

    def _release(self, key):
        self.live -= self._live.pop(key)

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live += self._live[key]
            weakref.finalize(st, self._release, key).atexit = False
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        namespace, name = func._schema.name.split("::")
        if namespace in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                moved = list(_tensors(out)) or list(_tensors(args[:1]))
                self.collective_by_type[kind] += sum(map(_nbytes, moved))
                self.collective_counts[kind] += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        self.bytes += self._op_bytes(name, args, kwargs, out)
        self._track(out)
        return out

    @staticmethod
    def _op_bytes(name, args, kwargs, out):
        if name in _ALLOC:
            return 0
        if name in _SCATTER:
            # read the update (and any index), write it into the target
            u = _SCATTER[name]
            index = sum(_nbytes(t) for i, a in enumerate(args[1:], 1)
                        if i != u for t in _tensors(a))
            written = _nbytes(args[0]) if name == "copy_" \
                else _nbytes(args[u])
            return _nbytes(args[u]) + written + index
        outs = list(_tensors(out))
        if not outs:
            return 0                     # metadata (prim::device, .item())
        ins = list(_tensors((args, kwargs)))
        if not name.endswith("_"):
            read = {id(t.untyped_storage()) for t in ins}
            if all(id(t.untyped_storage()) in read for t in outs):
                return 0                 # a view of an input: no traffic
        return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


def trace(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its analysis dict): ``analyze``'s keys."""
    rec = OpRecorder((args, kwargs))
    with rec:
        out = fn(*args, **kwargs)
    made = {}
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in rec._args:
            made[id(st)] = st.nbytes()
    res = {
        "flops": rec.flops,
        "bytes": rec.bytes,
        "collective_by_type": dict(rec.collective_by_type),
        "collective_counts": dict(rec.collective_counts),
        "collective_bytes": float(sum(rec.collective_by_type.values())),
        "memory": {
            "argument_size_in_bytes": rec.argument_bytes,
            "output_size_in_bytes": sum(made.values()),
            "peak_size_in_bytes": rec.peak,
            "temp_size_in_bytes": rec.peak - rec.argument_bytes,
        },
    }
    return out, res


def analyze(fn, *args, **kwargs):
    """The reference's keys (``flops``, ``bytes``, ``collective_by_type``,
    ``collective_counts``, ``collective_bytes``) and ``memory``, for one
    call of ``fn``."""
    return trace(fn, *args, **kwargs)[1]
