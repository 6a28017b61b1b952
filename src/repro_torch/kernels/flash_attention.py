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

Under autograd (``models.attention``'s kernel route) the forward is
called with ``residuals=True``: the bf16 kernel then also writes what
the backward reads, each row's log-sum-exp of the scaled scores and the
output in f32 before its rounding. ``flash_attention_bwd`` is the
backward of causal self-attention from those, in
``csrc/flash_attention_bwd.cu`` (hd 64 and 128, bf16; three launches a
call, ``BWD_LAUNCHES`` counts calls); ``flash_attention_bwd_plain`` its
plain version, which CPU tensors take.

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
# ... and the backward kernel: qwen2-0.5b and tinyllama-1.1b 64; qwen3-8b,
# the deepseek and llama-vision cuts 128.
BWD_HEAD_DIMS = (64, 128)
# The backward's (B, H, S) f32 scratch rows are padded to whole 128-row
# tiles.
BWD_ROWS = 128

# Calls that launched the CUDA kernel (1 CUDA launch each) in this
# process. chip_smoke.py zeroes it before an LM prefill and reads it
# after, to show the prefill went through the kernel.
LAUNCHES = counts.Counter()     # launched calls, by thread
BWD_LAUNCHES = counts.Counter()  # launched backward calls, by thread

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          residuals=False):
    """The plain PyTorch version (the reference's dense oracle
    ``flash_attention_ref``): q scaled by ``hd**-0.5`` in f32, masked
    scores set to -1e30, softmax and the PV product in f32, cast to q's
    dtype. A row with no visible key averages v over all keys, as the
    reference's softmax of equal scores does. ``residuals``: returns
    (out, lse (B, H, Sq) f32, the f32 output (B, Sq, H, hd)), as the
    kernel does."""
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
    o = torch.einsum("bkgij,bjkd->bikgd", p, v.float()).reshape(B, Sq, H,
                                                                  hd)
    if not residuals:
        return o.to(q.dtype)
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o.to(q.dtype), lse, o


def _visible(S, window, device):
    """(S, S) bool: key j visible to query i in causal self-attention
    (j <= i, and i - j < window where one is given)."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = i >= j
    if window is not None:
        m &= (i - j) < window
    return m


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, window=None):
    """The plain backward of causal self-attention (q, dout (B, S, H, hd);
    k, v (B, S, KV, hd)) from the forward's residuals, o (B, S, H, hd)
    and lse (B, H, S), as the kernel computes it, in f32: p = exp(s -
    lse) with s = hd^-0.5 q.k (masked pairs 0), dp = dout.v, D =
    rowsum(dout * o), ds = p (dp - D); dv = p^T dout, dk = hd^-0.5 ds^T q
    (both summed over the query heads of a kv head), dq = hd^-0.5 ds k.
    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.float().reshape(B, S, KV, G, hd)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bikgd,bjkd->bkgij", qf, kf).mul_(scale)
    p = s.sub_(lse.float().reshape(B, KV, G, S)[..., None]).exp_()
    p.masked_fill_(~_visible(S, window, q.device), 0.0)
    dsum = (dout.float() * o.float()).sum(-1)            # (B, S, H)
    dsum = dsum.permute(0, 2, 1).reshape(B, KV, G, S)
    ds = torch.einsum("bikgd,bjkd->bkgij", dof, vf)
    ds.sub_(dsum[..., None]).mul_(p)
    dv = torch.einsum("bkgij,bikgd->bjkd", p, dof)
    del p
    dq = torch.einsum("bkgij,bjkd->bikgd", ds, kf).mul_(scale)
    dk = torch.einsum("bkgij,bikgd->bjkd", ds, qf).mul_(scale)
    return tuple(g.to(t.dtype) for g, t in zip((dq.reshape(B, S, H, hd), dk,
                                                dv), (q, k, v)))


def _library():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
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


def flash_attention(q, k, v, *, causal=True, window=None, residuals=False):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query head h reads kv head ``h // (H // KV)``. CUDA tensors
    launch the kernel (or raise, also when autograd would record the call:
    ``guard.refuse_autograd``); CPU tensors take
    ``flash_attention_plain``. ``residuals`` (bf16 only on the card):
    returns (out, lse (B, H, Sq) f32, the f32 output (B, Sq, H, hd)), the
    kernel writing both beside ``out``."""
    B, Sq, Sk, H, KV, hd = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     residuals=residuals)
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
    if residuals and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention's kernel writes residuals in "
                         f"bf16 only, got {q.dtype}")
    lib = _library()
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty_like(q)
        lse = o32 = None
        if residuals:
            lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
            o32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse), _ptr(o32), B, Sq, Sk, H, KV, hd, int(bool(causal)),
            int(window is not None),
            int(window) if window is not None else 0, hd ** -0.5,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    LAUNCHES.bump()
    return (out, lse, o32) if residuals else out


def _ptr(t):
    """A tensor's address for the C entry points; None (a null pointer)
    for no tensor."""
    return None if t is None else t.data_ptr()


def flash_attention_bwd(q, k, v, o, lse, dout, *, window=None, f32=False):
    """The backward of ``flash_attention(q, k, v, causal=True, window=)``
    for self-attention: q, dout (B, S, H, hd) and k, v (B, S, KV, hd)
    bf16; o (B, S, H, hd) and lse (B, H, S), the f32 residuals that the
    forward returns with ``residuals=True``. Returns (dq, dk, dv) in
    bf16, f32 accumulation inside, or in f32 with ``f32``. CUDA tensors
    launch ``csrc/flash_attention_bwd.cu`` (or raise); CPU tensors take
    ``flash_attention_bwd_plain``."""
    B, S, Sk, H, KV, hd = _check(q, k, v, window)
    if dout.shape != q.shape or o.shape != q.shape or tuple(
            lse.shape) != (B, H, S) or Sk != S:
        raise ValueError(f"flash_attention_bwd takes self-attention (Sq = "
                         f"Sk) with dout and o of q's shape and lse (B, H, "
                         f"S); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"dout {tuple(dout.shape)}, o {tuple(o.shape)}, "
                         f"lse {tuple(lse.shape)}")
    if q.device.type == "cpu":
        if f32:
            q, k, v, dout = (t.float() for t in (q, k, v, dout))
        return flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    if q.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16 or (
            o.dtype != torch.float32 or lse.dtype != torch.float32):
        raise TypeError(f"flash_attention_bwd's kernel takes bf16 q, k, v, "
                        f"dout and f32 o, lse; got {q.dtype}, {dout.dtype}, "
                        f"{o.dtype}, {lse.dtype}")
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd's kernel takes hd in "
                         f"{BWD_HEAD_DIMS}, got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd takes a window >= 1, got "
                         f"{window}")
    ts = (q, k, v, o, lse, dout)
    if not all(t.is_contiguous() and t.device == q.device for t in ts):
        raise ValueError("flash_attention_bwd's kernel takes contiguous "
                         "q, k, v, o, lse, dout on one device")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention_bwd's kernel takes operands "
                         "starting on 16-byte boundaries")
    if B * H >= 2 ** 16:
        raise ValueError(f"flash_attention_bwd's kernel takes B*H < 65536, "
                         f"got {B * H}")
    lib = _library()
    dev = q.device
    Sp = -(-S // BWD_ROWS) * BWD_ROWS
    with torch.cuda.device(dev):
        scratch = torch.empty((2, B, H, Sp), dtype=torch.float32,
                              device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dk32, dv32 = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                      for t in (k, v))
        dq32 = (torch.empty(q.shape, dtype=torch.float32, device=dev)
                if f32 else None)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            o.data_ptr(), lse.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(dq32), dk32.data_ptr(), dv32.data_ptr(), B, S,
            Sp, H, KV, hd, int(window is not None),
            int(window) if window is not None else 0, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    BWD_LAUNCHES.bump()
    return (dq32, dk32, dv32) if f32 else (dq, dk, dv)
