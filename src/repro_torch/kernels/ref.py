"""Plain PyTorch oracles for the port's kernels (``repro.kernels.ref``'s
counterparts) for ``ops.ff_dense``, whose arithmetic lives once, in
``kernels.ff_dense.ff_dense_plain``; autograd differentiates them (the
reference's ``impl="ref"`` anchor). The backward's plain version is
``kernels.ff_dense_vjp.ff_dense_bwd_plain``."""
from __future__ import annotations

from repro_torch.kernels.ff_dense import ff_dense_plain


def ff_dense_ref(x, w, b):
    """f32 accumulate, relu, ``g = sum(y*y)``; y in x's dtype."""
    return ff_dense_plain(x, w, b, norm=False)


def ff_dense_norm_ref(x, w, b):
    """``ff_dense_ref`` with Hinton's length normalization applied to the
    (already cast) y: ``y / (sqrt(g) + NORM_EPS)``, sum then sqrt, as the
    reference composes it. g stays the raw pre-norm goodness."""
    return ff_dense_plain(x, w, b, norm=True)
