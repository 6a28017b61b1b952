"""The PFF executor's nodes (the node-device part of
``repro.launch.mesh``; the production and pod meshes come with the pod
slice).

A paper "node" of the executor (``core.pff_exec.PFFExecutor``) is a
device plus, on the card, a CUDA stream of its own. The machine the
port targets has one H100, so N logical nodes are N x ``cuda:0``, each
with its own stream (the executor makes the streams); on the CPU they
are N x ``cpu`` and run in order.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import resolve_device


def pff_node_devices(num_nodes: int, device=None) -> List[torch.device]:
    """One device per paper node for the PFF executor: ``num_nodes``
    times ``device`` (``None`` = ``cuda``, raising without a GPU;
    ``"cpu"`` for the plain path)."""
    if num_nodes < 1:
        raise ValueError(f"num_nodes must be >= 1, got {num_nodes}")
    return [resolve_device(device)] * num_nodes
