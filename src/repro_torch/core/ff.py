"""Forward-Forward primitives (Hinton 2022, as used by the PFF paper):
goodness and the image label overlay. The port of ``repro.core.ff``'s
prediction-side functions; the losses and negative-label strategies
come with the training slice.

Image samples follow the paper: the first ``num_classes`` pixels of the
flattened image carry a one-hot label overlay (positive = true label,
negative = a wrong label, neutral = uniform 1/C for Softmax prediction).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def goodness(y):
    """Sum of squared activities over the feature axis (paper Eq. 1)."""
    return torch.sum(torch.square(y.float()), dim=-1)


def mean_goodness(y):
    """Dimension-normalized goodness: scale-free across layer widths."""
    return torch.mean(torch.square(y.float()), dim=-1)


def overlay_label(x, label, num_classes):
    """x: (B, D) in [0,1]; label: (B,) int or (B, C) float distribution."""
    if label.dim() == 1:
        lab = F.one_hot(label.long(), num_classes).to(x.dtype)
    else:
        lab = label.to(x.dtype)
    return torch.cat([lab, x[:, num_classes:]], dim=1)


def overlay_neutral(x, num_classes):
    lab = torch.full((x.shape[0], num_classes), 1.0 / num_classes,
                     dtype=x.dtype, device=x.device)
    return torch.cat([lab, x[:, num_classes:]], dim=1)
