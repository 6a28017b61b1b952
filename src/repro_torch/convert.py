"""Parameter trees between numpy and the port.

The reference's parameters are a pytree of JAX arrays; as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) they enter the port
through ``params_from_numpy`` with the same keys, nesting, shapes and
dtypes, and leave it through ``params_to_numpy``. A bf16 leaf is an
``ml_dtypes.bfloat16`` numpy array, which ``torch.tensor`` rejects; it
crosses bit for bit as its 16-bit pattern.
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


def tree_stack(trees):
    """Trees of one structure -> one tree whose leaves are the stacked
    leaves (a new leading axis), as ``jax.vmap`` over an init gives."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.int16))        # owned, writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                         # numpy's bf16 type
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device):
    """numpy leaves -> tensors on ``device`` (copies, so a read-only or
    later-mutated source array never aliases the port's weights)."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """tensor leaves -> numpy arrays on the host (bf16 leaves as
    ``ml_dtypes.bfloat16``, the type the reference's arrays convert to)."""
    return tree_map(_to_numpy, tree)
