"""Blockwise online-softmax attention (GQA, causal and/or sliding window).

The port of ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas ``_kernel``). The kernel itself is CUDA C++ in
``csrc/flash_attention.cu``, whose header note gives its design and
bound. bf16 runs on the tensor cores (``wgmma``, f32 accumulation):
Q.K^T on bf16 operands with hd^-0.5 applied to the f32 scores, and P.V
as two bf16 products, P split into bf16(p) and bf16(p - bf16(p)), which
keeps the reference's f32 P to about 2^-17; two warpgroups of 64 q rows
a block; k and v stream through a 2-stage ``cp.async`` ring of 64-key
tiles. f32 runs the FMA kernel. Both keep the online softmax in f32
registers and skip fully masked k tiles. One call is one CUDA launch;
``LAUNCHES`` counts calls.

``flash_attention`` takes q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), all
f32 or all bf16, and returns (B, Sq, H, hd) in q's dtype. The kernel
takes hd in ``KERNEL_HEAD_DIMS`` (64, 120, 128, 256) and any Sq, Sk
(ragged tiles are masked); it pads hd 120 to 128 with zero columns in
shared memory. On CUDA tensors it launches the kernel or raises; on CPU
tensors it computes the same function with ``flash_attention_plain``,
because the kernel cannot run there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counts
from repro_torch.kernels.guard import refuse_autograd

NEG_INF = -1e30
# Head widths the kernel is compiled for: qwen2-0.5b and tinyllama-1.1b
# 64, h2o-danube-3-4b 120, qwen3-8b 128, recurrentgemma-2b 256.
KERNEL_HEAD_DIMS = (64, 120, 128, 256)

# Calls that launched the CUDA kernel (1 CUDA launch each) in this
# process. chip_smoke.py zeroes it before an LM prefill and reads it
# after, to show the prefill went through the kernel.
LAUNCHES = counts.Counter()     # launched calls, by thread

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
    launch the kernel (or raise, also when autograd would record the call:
    ``guard.refuse_autograd``); CPU tensors take
    ``flash_attention_plain``."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    refuse_autograd("flash_attention", q, k, v)
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
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention's bf16 kernel takes q, k, v "
                         "starting on 16-byte boundaries (it copies rows in "
                         "16-byte chunks)")
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
    LAUNCHES.bump()
    return out
