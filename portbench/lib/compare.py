"""The comparison that decides ``correct``.

Every number is a gap between the program's reading and the reference's,
taken by the worst leaf: the gap between two norms (never the norm of the
difference), over the reference's norm of that leaf or of the median
leaf, whichever is larger, since some gradients are all but zero. Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone and are left out of the change.
"""
from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def worst_leaf_gap(prog, ref, keep=None):
    """max over the leaves of | |prog| - |ref| | / max(|ref|, median)."""
    names = [n for n in ref if keep is None or n in keep]
    ref_n = {n: _norm(ref[n]) for n in names}
    med = statistics.median(ref_n.values())
    return max(abs(_norm(prog[n].to(ref[n].device)) - ref_n[n])
               / max(ref_n[n], med) for n in names)


def moved(grads):
    """The leaves whose gradient is not nought to rounding."""
    norms = {n: _norm(g) for n, g in grads.items()}
    med = statistics.median(norms.values())
    return {n for n, v in norms.items() if v >= NEGLIGIBLE * med}


def change(after, before):
    return {n: after[n].to(before[n].device).float() - before[n].float()
            for n in after}


def loss_gap(prog, ref):
    """max over the steps of |prog - ref| / |ref|."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def judge(numbers, limits):
    """(correct, lines): each number beside its limit; a number that is
    missing or not finite fails."""
    ok = True
    lines = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        lines[name] = {"value": v, "limit": limit}
    return ok, lines
