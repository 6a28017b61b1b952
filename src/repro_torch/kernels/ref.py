"""Plain PyTorch oracles for the port's kernels (``repro.kernels.ref``'s
counterparts), for the ``impl="ref"`` anchor of ``ops``. Each op's
arithmetic lives once, in its kernel module's plain version
(``ff_dense_plain``, ``flash_attention_plain``, ``mamba2_ssd_plain``);
autograd differentiates them. The backward's plain version is
``kernels.ff_dense_vjp.ff_dense_bwd_plain``."""
from __future__ import annotations

from repro_torch.kernels.ff_dense import ff_dense_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_plain

__all__ = ["ff_dense_ref", "ff_dense_norm_ref", "flash_attention_plain",
           "flash_attention_ref", "mamba2_ssd_plain", "mamba2_ssd_ref"]


def ff_dense_ref(x, w, b):
    """f32 accumulate, relu, ``g = sum(y*y)``; y in x's dtype."""
    return ff_dense_plain(x, w, b, norm=False)


def ff_dense_norm_ref(x, w, b):
    """``ff_dense_ref`` with Hinton's length normalization applied to the
    (already cast) y: ``y / (sqrt(g) + NORM_EPS)``, sum then sqrt, as the
    reference composes it. g stays the raw pre-norm goodness."""
    return ff_dense_plain(x, w, b, norm=True)


# dense masked softmax attention in f32, out in q's dtype
flash_attention_ref = flash_attention_plain
# the chunked SSD dual form in f32: (y, hT)
mamba2_ssd_ref = mamba2_ssd_plain
