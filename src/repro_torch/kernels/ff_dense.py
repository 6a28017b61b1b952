"""Fused FF layer: y = relu(x @ w + b), g = sum(y^2, axis=-1).

The port of ``repro/kernels/ff_dense.py::ff_dense`` (the Pallas
``_kernel`` and ``_kernel_norm``). The kernel itself is CUDA C++ in
``csrc/ff_dense.cu``, whose header note gives its design and bound: a
split-K GEMM on the tensor cores (``mma.sync`` TF32, as 3xTF32 for f32
operands) writing S partial products of K slices into an (S, M, N) f32
scratch, then a finish launch, one block per row, that sums the slices
in order, adds the bias, applies relu, stores y, reduces g and, with
``norm=True``, divides the row by ``sqrt(g) + NORM_EPS``. ``_fwd_split``
picks S and ``_fwd_tile`` the block width. One ``ff_dense`` call is
therefore 2 CUDA launches; ``LAUNCHES`` counts calls.

``ff_dense`` takes f32 or bf16 operands (all three of one dtype) and
returns ``y`` in that dtype and ``g`` in f32. On CUDA tensors it
launches the kernel or raises; on CPU tensors it computes the same
function with ``ff_dense_plain``, because the kernel cannot run there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, counts

# Hinton's inter-layer normalization epsilon, shared by the kernel
# (csrc/ff_dense.cu), the plain version, the oracles and ff_mlp._norm.
NORM_EPS = 1e-8

# Calls that launched the CUDA kernel (2 CUDA launches each) in this
# process. chip_smoke.py zeroes it before the serving run and reads it
# after, to show the serving path went through the kernel.
LAUNCHES = counts.Counter()     # launched calls, by thread

# gemm_split's block tile rows (m), the block widths (n) it is built for,
# and its ring-stage depth (k), as in csrc/ff_dense.cu.
FWD_BM, FWD_BNS, FWD_BK = 128, (64, 128), 32
# gemm_split blocks wanted: two on each of the H100's 132 SMs (its shared
# memory holds two at a time), rounded to a power of two.
FWD_BLOCKS = 256
# k a slice covers at least: four ring stages, so that a slice's loop is
# long against the ring's fill.
FWD_MIN_SLICE = 4 * FWD_BK
# The launch bits of ff_dense_launch: gemm_split, finish_rows.
GEMM, FINISH = 1, 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def ff_dense_plain(x, w, b, *, norm=False):
    """The plain PyTorch version, in the reference's op order: f32
    accumulate, relu, ``g = sum(y*y)``, cast y to x's dtype, then (norm)
    ``y / (sqrt(g) + NORM_EPS)`` cast again."""
    y = torch.relu(torch.matmul(x.float(), w.float()) + b.float()[None, :])
    g = torch.sum(y * y, dim=1)
    y = y.to(x.dtype)
    if norm:
        y = (y.float() / (torch.sqrt(g)[:, None] + NORM_EPS)).to(x.dtype)
    return y, g


def _fwd_tile(M, N):
    """gemm_split's block width: 128 columns where the 64-wide output
    tiles alone number ``FWD_BLOCKS // 2`` or more (160 at the serving
    M = 640), since the wider tile reads each x tile half as often and
    splitting K still gives every SM work; else 64 (32 tiles at the
    training M)."""
    narrow, wide = FWD_BNS
    tiles = -(-N // narrow) * -(-M // FWD_BM)
    return wide if tiles >= FWD_BLOCKS // 2 else narrow


def _fwd_split(M, K, N, bn=None):
    """(S, L): gemm_split cuts the reduction over K into S slices of L,
    [s*L, min((s+1)*L, K)), each non-empty and L a multiple of the stage
    depth, so that its (N/bn) * (M/128) * S blocks come near
    ``FWD_BLOCKS`` without a slice shorter than ``FWD_MIN_SLICE`` (when K
    allows); bn defaults to ``_fwd_tile``. 256 blocks at (128, 2000,
    2000), 224 at K 784, 240 at the serving M = 640 (bn 128)."""
    bn = bn or _fwd_tile(M, N)
    tiles = -(-N // bn) * -(-M // FWD_BM)
    want = max(1, round(FWD_BLOCKS / tiles))
    slices = max(1, min(want, -(-K // FWD_MIN_SLICE)))
    L = -(-(-(-K // slices)) // FWD_BK) * FWD_BK
    return -(-K // L), L


def _library():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.ff_dense_launch.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
        lib.ff_dense_launch.restype = ctypes.c_int
        lib.ff_dense_error_string.argtypes = [ctypes.c_int]
        lib.ff_dense_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, w, b):
    """Shapes, dtypes and devices the kernel takes; returns (M, K, N)."""
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"ff_dense expects x (M, K), w (K, N), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    (M, K), (K2, N) = x.shape, w.shape
    if K2 != K or b.shape[0] != N:
        raise ValueError(f"ff_dense shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.dtype not in _DTYPE_CODES or not x.dtype == w.dtype == b.dtype:
        raise TypeError(f"ff_dense takes x, w, b all float32 or all "
                        f"bfloat16; got {x.dtype}, {w.dtype}, {b.dtype}")
    if not x.device == w.device == b.device:
        raise ValueError(f"ff_dense operands on different devices: "
                         f"{x.device}, {w.device}, {b.device}")
    return M, K, N


def _launch(x, w, b, norm, parts=GEMM | FINISH, bn=None):
    """Launches the kernel's parts named by the bits of ``parts`` on CUDA
    operands that ``_check`` passed; returns (y, g). Only both parts
    make the outputs: a single part is launched to time it. ``bn``
    overrides ``_fwd_tile``'s block width, to time the other one."""
    M, K, N = x.shape[0], x.shape[1], w.shape[1]
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("ff_dense's kernel takes contiguous row-major "
                         "x, w and b")
    if M == 0 or K == 0 or N == 0:
        raise ValueError(f"ff_dense's kernel takes no empty dimension, got "
                         f"M={M}, K={K}, N={N}")
    bn = bn or _fwd_tile(M, N)
    if bn not in FWD_BNS:
        raise ValueError(f"ff_dense's kernel is built for block widths "
                         f"{FWD_BNS}, got {bn}")
    S, L = _fwd_split(M, K, N, bn)
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        y = torch.empty((M, N), dtype=x.dtype, device=dev)
        g = torch.empty((M,), dtype=torch.float32, device=dev)
        part = torch.empty((S, M, N), dtype=torch.float32, device=dev)
        err = lib.ff_dense_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            g.data_ptr(), part.data_ptr(), M, K, N, S, L, bn, int(norm),
            _DTYPE_CODES[x.dtype], parts,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ff_dense kernel launch failed: "
                           f"{lib.ff_dense_error_string(err).decode()}")
    return y, g


def ff_dense(x, w, b, *, norm=False):
    """x (M, K), w (K, N), b (N,) -> (y (M, N) in x.dtype, g (M,) f32).

    norm=True: y is returned as ``y / (sqrt(g) + NORM_EPS)``; g stays the
    raw pre-norm goodness. CUDA tensors launch the kernel (or raise);
    CPU tensors take ``ff_dense_plain``.
    """
    _check(x, w, b)
    if x.device.type == "cpu":
        return ff_dense_plain(x, w, b, norm=norm)
    if x.device.type != "cuda":
        raise ValueError(f"ff_dense runs on cuda or cpu tensors, got "
                         f"{x.device}")
    out = _launch(x, w, b, norm)
    LAUNCHES.bump()
    return out
