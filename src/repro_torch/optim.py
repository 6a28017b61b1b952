"""Adam over trees of tensors, and the paper's learning-rate cooldown
(``repro.optim``'s counterpart).

State: ``{"m": tree, "v": tree}`` in float32, the params' structure.
The step count is passed explicitly (the training loop's 1-based step
counter), so the state is tensors only.

The scalar arithmetic runs in float32 tensors, as the reference's does
under jit (``b1 ** t``, the bias corrections, the cooldown's clip), not
in Python doubles. The 0-d scalars live on the CPU, so an update on the
card reads them without a device round trip.

``adam_update`` updates params and state IN PLACE and returns them: the
counterpart of the reference trainers' donated buffers. A caller that
still needs the old values copies them first.
"""
from __future__ import annotations

import torch

from repro_torch.convert import tree_leaves, tree_map


def adam_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adam_update(params, grads, state, *, lr, step, b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.0):
    """One Adam step over matching trees; ``step`` is 1-based, ``lr`` a
    float or a 0-d float32 tensor. Updates ``params`` and ``state`` in
    place and returns ``(params, state)``."""
    t = torch.tensor(step, dtype=torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        gf = g.float()
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * torch.square(gf))
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, state


def cooldown_lr(base_lr, epoch, total_epochs, cooldown_after=0.5):
    """Paper §5.1: constant LR, then linear decay to 0 after the
    midpoint. Returns a 0-d float32 tensor."""
    frac = torch.tensor(epoch, dtype=torch.float32) / max(total_epochs, 1)
    scale = torch.clamp((1.0 - frac) / max(1.0 - cooldown_after, 1e-9),
                        0.0, 1.0)
    return base_lr * scale
