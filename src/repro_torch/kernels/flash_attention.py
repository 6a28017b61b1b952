"""Blockwise online-softmax attention (GQA, causal and/or sliding window).

The port of ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas ``_kernel``). The kernel itself is CUDA C++ in
``csrc/flash_attention.cu``, whose header note gives its design and
bound: one block per (64-row q tile, batch x head), k and v streamed
through shared memory in 64-row tiles of the kv head ``h // G``, the
online softmax in f32 registers, fully masked k tiles skipped. One call
is one CUDA launch; ``LAUNCHES`` counts calls.

``flash_attention`` takes q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), all
f32 or all bf16, and returns (B, Sq, H, hd) in q's dtype. The kernel
takes hd in {64, 128} and any Sq, Sk (ragged tiles are masked). On CUDA
tensors it launches the kernel or raises; on CPU tensors it computes the
same function with ``flash_attention_plain``, because the kernel cannot
run there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# Head widths the kernel is compiled for (qwen2: 64; the other configs
# of the reference: 128).
KERNEL_HEAD_DIMS = (64, 128)

# Calls that launched the CUDA kernel (1 CUDA launch each) in this
# process. chip_smoke.py zeroes it before an LM prefill and reads it
# after, to show the prefill went through the kernel.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The plain PyTorch version (the reference's dense oracle
    ``flash_attention_ref``): q scaled by ``hd**-0.5`` in f32, masked
    scores set to -1e30, softmax and the PV product in f32, cast to q's
    dtype. A row with no visible key averages v over all keys, as the
    reference's softmax of equal scores does."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qf = q.float() * hd ** -0.5
    qf = qf.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bikgd,bjkd->bkgij", qf, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= qpos >= kpos
    if window is not None:
        m &= (qpos - kpos) < window
    s = torch.where(m, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, window):
    """Shapes, dtypes and devices the op takes; returns its sizes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention expects q (B, Sq, H, hd), k and v "
                         f"(B, Sk, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or KV == 0 or H % KV):
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (H must be "
                         f"a multiple of KV)")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention takes q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention operands on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if window is not None and int(window) != window:
        raise TypeError(f"flash_attention window must be an int or None, "
                        f"got {window!r}")
    return B, Sq, Sk, H, KV, hd


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query head h reads kv head ``h // (H // KV)``. CUDA tensors
    launch the kernel (or raise); CPU tensors take
    ``flash_attention_plain``."""
    global LAUNCHES
    B, Sq, Sk, H, KV, hd = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes hd in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel takes contiguous q, k, v")
    if B * Sq * Sk * H == 0:
        raise ValueError(f"flash_attention's kernel takes no empty dimension, "
                         f"got B={B}, Sq={Sq}, Sk={Sk}, H={H}")
    if B * H >= 2 ** 16:
        raise ValueError(f"flash_attention's kernel takes B*H < 65536, got "
                         f"{B * H}")
    lib = _library()
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0, hd ** -0.5,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    LAUNCHES += 1
    return out
