"""Chunked Mamba-2 SSD (state-space duality) scan.

The port of ``repro/kernels/mamba2_ssd.py::mamba2_ssd`` (the Pallas
``_kernel``). Per chunk of L steps (``cums = cumsum(dA)``):

  y[i]  = sum_{j<=i} (c_i . b_j) exp(cums_i - cums_j) xbar_j
          + (c_i . h) exp(cums_i)                    (carried state h)
  h    <- h exp(cums_L) + sum_j exp(cums_L - cums_j) b_j xbar_j

The kernel is CUDA C++ in ``csrc/mamba2_ssd.cu``, whose header note
gives its design and bound: the chunk-parallel SSD decomposition in four
launches, every product on the tensor cores as 3xTF32 (``mma.sync``):
(1) the chunks' ``c_i . b_j`` scores, shared by every head; (2) each
(sequence, chunk, head)'s own state into an (B, nc, H, hd, N) scratch;
(3) the state recurrence over the chunks in order, elementwise, leaving
the state that enters each chunk and hT; (4) y per 64-row tile of each
(sequence, chunk, head). One call is four CUDA launches; ``LAUNCHES``
counts calls.

``mamba2_ssd`` takes xbar (B, S, H, hd), dA (B, S, H), b and c
(B, S, N), all f32 (the model forms dA and xbar in f32 and widens b and
c), and returns y (B, S, H, hd) f32 and hT (B, H, hd, N) f32. S need not
be a chunk multiple: the kernel masks the ragged last chunk and the
plain version pads it with zero rows, which are inert (dt = 0). On CUDA
tensors it launches the kernel or raises; on CPU tensors it computes the
same function with ``mamba2_ssd_plain``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# What the kernel is compiled for: chunk lengths, state sizes and head
# dims (one block covers a whole head's hd).
KERNEL_CHUNKS = (128, 256)
KERNEL_STATE_DIMS = (128,)
KERNEL_HEAD_DIMS = (64,)
# The launch bits of mamba2_ssd_launch: scores, chunk states, state pass,
# output.
SCORES, STATES, STATE_PASS, OUTPUT = 1, 2, 4, 8

# Calls that launched the CUDA kernel (4 CUDA launches each) in this
# process. chip_smoke.py zeroes it before an LM prefill and reads it
# after, to show the prefill went through the kernel.
LAUNCHES = 0

_lib = None


def mamba2_ssd_plain(xbar, dA, b, c, *, chunk=128):
    """The plain PyTorch version, the reference's chunked dual form
    (``models/ssm.py::ssd_chunked`` after its dA and xbar): chunks of
    ``L = min(chunk, S)``, S padded to a multiple of L with zero rows,
    one Python step per chunk carrying the (B, H, hd, N) f32 state."""
    B, S, H, hd = xbar.shape
    N = b.shape[-1]
    L = min(chunk, S)
    if S % L:
        pad = L - S % L
        y, hT = mamba2_ssd_plain(
            F.pad(xbar, (0, 0, 0, 0, 0, pad)), F.pad(dA, (0, 0, 0, pad)),
            F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)), chunk=chunk)
        return y[:, :S], hT
    nc = S // L
    dA = dA.float().reshape(B, nc, L, H)
    xbar = xbar.float().reshape(B, nc, L, H, hd)
    bc = b.float().reshape(B, nc, L, N)
    cc = c.float().reshape(B, nc, L, N)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xbar.device))
    zero = torch.zeros((), device=xbar.device)
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xbar.device)
    ys = []
    for i in range(nc):
        dA_c, xbar_c, b_c, c_c = dA[:, i], xbar[:, i], bc[:, i], cc[:, i]
        cums = torch.cumsum(dA_c, dim=1)                     # (B, L, H)
        # intra-chunk dual form
        seg = cums[:, :, None, :] - cums[:, None, :, :]      # (B, i, j, H)
        decay = torch.where(mask[None, :, :, None], torch.exp(seg), zero)
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)
        y = torch.einsum("bijh,bjhd->bihd", scores[..., None] * decay,
                         xbar_c)
        # inter-chunk: contribution of the carried state
        decay_in = torch.exp(cums)                           # (B, L, H)
        y = y + torch.einsum("bin,bhdn->bihd", c_c, h) * decay_in[..., None]
        # state update
        last = cums[:, -1:, :]                               # (B, 1, H)
        decay_out = torch.exp(last - cums)                   # (B, L, H)
        st = torch.einsum("bjn,bjhd->bhdn", b_c,
                          xbar_c * decay_out[..., None])
        h = h * torch.exp(last[:, 0, :])[..., None, None] + st
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), h


def _library():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.mamba2_ssd_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.mamba2_ssd_launch.restype = ctypes.c_int
        lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
        lib.mamba2_ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(xbar, dA, b, c):
    """Shapes, dtypes and devices the op takes; returns its sizes."""
    if xbar.dim() != 4 or dA.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(f"mamba2_ssd expects xbar (B, S, H, hd), dA "
                         f"(B, S, H), b and c (B, S, N); got "
                         f"{tuple(xbar.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    B, S, H, hd = xbar.shape
    N = b.shape[-1]
    if (tuple(dA.shape) != (B, S, H) or tuple(b.shape) != (B, S, N)
            or c.shape != b.shape):
        raise ValueError(f"mamba2_ssd shape mismatch: xbar "
                         f"{tuple(xbar.shape)}, dA {tuple(dA.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if not (xbar.dtype == dA.dtype == b.dtype == c.dtype == torch.float32):
        raise TypeError(f"mamba2_ssd takes float32 xbar, dA, b, c; got "
                        f"{xbar.dtype}, {dA.dtype}, {b.dtype}, {c.dtype}")
    if not xbar.device == dA.device == b.device == c.device:
        raise ValueError(f"mamba2_ssd operands on different devices: "
                         f"{xbar.device}, {dA.device}, {b.device}, "
                         f"{c.device}")
    return B, S, H, hd, N


def _launch(xbar, dA, b, c, chunk, parts=SCORES | STATES | STATE_PASS
            | OUTPUT):
    """Launches the kernel's parts named by the bits of ``parts`` on CUDA
    operands that ``_check`` passed; returns (y, hT). Only all four parts
    make the outputs: a single part is launched to time it."""
    B, S, H, hd = xbar.shape
    N = b.shape[-1]
    if chunk not in KERNEL_CHUNKS:
        raise ValueError(f"mamba2_ssd's kernel takes chunk in "
                         f"{KERNEL_CHUNKS}, got {chunk}")
    if N not in KERNEL_STATE_DIMS or hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"mamba2_ssd's kernel takes N in "
                         f"{KERNEL_STATE_DIMS} and hd in {KERNEL_HEAD_DIMS}; "
                         f"got N={N}, hd={hd}")
    if not all(t.is_contiguous() for t in (xbar, dA, b, c)):
        raise ValueError("mamba2_ssd's kernel takes contiguous operands")
    if B * S * H == 0:
        raise ValueError(f"mamba2_ssd's kernel takes no empty dimension, got "
                         f"B={B}, S={S}, H={H}")
    nc = -(-S // chunk)
    if B * nc >= 2 ** 16 or H >= 2 ** 16:
        raise ValueError(f"mamba2_ssd's kernel takes B*ceil(S/chunk) and H "
                         f"below 65536, got {B * nc} and {H}")
    lib = _library()
    dev = xbar.device
    with torch.cuda.device(dev):
        y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
        hT = torch.empty((B, H, hd, N), dtype=torch.float32, device=dev)
        # launch 1 writes the chunks' c_i . b_j scores (tiles on or below
        # the diagonal), launch 4 reads them
        cb = torch.empty((B * nc, chunk, chunk), dtype=torch.float32,
                         device=dev)
        # launch 2 writes each chunk's own state and its cums_L, launch 3
        # turns the states into those entering each chunk, launch 4 reads
        # them
        states = torch.empty((B, nc, H, hd, N), dtype=torch.float32,
                             device=dev)
        dlast = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
        err = lib.mamba2_ssd_launch(
            xbar.data_ptr(), dA.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), hT.data_ptr(), cb.data_ptr(), states.data_ptr(),
            dlast.data_ptr(), B, S, H, hd, N, chunk, parts,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: "
                           f"{lib.mamba2_ssd_error_string(err).decode()}")
    return y, hT


def mamba2_ssd(xbar, dA, b, c, *, chunk=128):
    """xbar (B, S, H, hd), dA (B, S, H), b, c (B, S, N), all f32 ->
    (y (B, S, H, hd) f32, hT (B, H, hd, N) f32). CUDA tensors launch the
    kernel (or raise); CPU tensors take ``mamba2_ssd_plain``."""
    global LAUNCHES
    _check(xbar, dA, b, c)
    if xbar.device.type == "cpu":
        return mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk)
    if xbar.device.type != "cuda":
        raise ValueError(f"mamba2_ssd runs on cuda or cpu tensors, got "
                         f"{xbar.device}")
    out = _launch(xbar, dA, b, c, chunk)
    LAUNCHES += 1
    return out
