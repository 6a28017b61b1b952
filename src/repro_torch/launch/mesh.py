"""Meshes (the port of ``repro.launch.mesh``): the production, pod-stage
and host meshes as ``torch.distributed`` device meshes, and the PFF
executor's nodes.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` built by
``init_device_mesh`` over the default process group, one process per
device, with the reference's shapes and axis names. The functions build
nothing when the module is imported; each needs the default group
initialized first (``torchrun --nproc_per_node N`` plus
``torch.distributed.init_process_group``), with a world size equal to
the product of the mesh's shape, and raises otherwise, as the
reference's raise names ``XLA_FLAGS``. The mesh's device type follows
the group's backend: ``cuda`` for NCCL, ``cpu`` for gloo.

A paper "node" of the PFF executor (``core.pff_exec.PFFExecutor``) is a
device plus, on the card, a CUDA stream of its own. The machine the
port targets has one H100, so N logical nodes are N x ``cuda:0``, each
with its own stream (the executor makes the streams); on the CPU they
are N x ``cpu`` and run in order.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (``jax.make_mesh``'s counterpart); raises unless the
    group is initialized with ``prod(shape)`` processes."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        have = (f"a default process group of {world}" if world
                else "no initialized process group")
        raise RuntimeError(
            f"mesh {dict(zip(axes, shape))} needs {n} processes, one per "
            f"device, but there is {have}; launch with torchrun "
            f"--nproc_per_node {n} (or --nnodes x --nproc_per_node = {n}) "
            f"and call torch.distributed.init_process_group first")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2,
    data=16, model=16), 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_pff_stage_mesh(*, stages: int = 2):
    """Beyond-paper PFF mode: the leading axis is the pipeline-STAGE axis,
    (stage, data=16, model=16). Each stage owns a contiguous layer range
    and sends its activations forward (``core.pff_pod``); FF has no
    backward pass, so nothing flows back."""
    return make_mesh((stages, 16, 16), ("stage", "data", "model"))


def make_host_mesh(axes=("data", "model")):
    """Every process of the default group as a (1, n) or (n,) mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((1, n) if len(axes) == 2 else (n,), axes)


def pff_node_devices(num_nodes: int, device=None) -> List[torch.device]:
    """One device per paper node for the PFF executor: ``num_nodes``
    times ``device`` (``None`` = ``cuda``, raising without a GPU;
    ``"cpu"`` for the plain path)."""
    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    return [resolve_device(device)] * num_nodes
