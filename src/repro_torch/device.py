"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, raising if no CUDA device is present (the
    port never carries on on the CPU by itself); anything else is taken
    as asked (``"cpu"``, ``"cuda:0"``, a ``torch.device``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
