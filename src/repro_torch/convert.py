"""Parameter trees between numpy and the port.

The reference's parameters are a pytree of JAX arrays; as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) they enter the port
through ``params_from_numpy`` with the same keys, nesting, shapes and
dtypes, and leave it through ``params_to_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in ``tree_map``'s
    order."""
    out = []
    tree_map(out.append, tree)
    return out


def params_from_numpy(tree, device):
    """numpy leaves -> tensors on ``device`` (copies, so a read-only or
    later-mutated source array never aliases the port's weights)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree):
    """tensor leaves -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
