"""Fused FF layer: y = relu(x @ w + b), g = sum(y^2, axis=-1).

The port of ``repro/kernels/ff_dense.py::ff_dense`` (the Pallas
``_kernel`` and ``_kernel_norm``). The kernel itself is CUDA C++ in
``csrc/ff_dense.cu``, whose header note gives its design and bound: a
tiled f32 GEMM whose epilogue adds the bias, applies relu, stores y and
writes per-block row partials of y^2, then a second launch that sums
the partials into g and, with ``norm=True``, divides each row of y by
``sqrt(g) + NORM_EPS``. One ``ff_dense`` call is therefore 2 CUDA
launches; ``LAUNCHES`` counts calls.

``ff_dense`` takes f32 or bf16 operands (all three of one dtype) and
returns ``y`` in that dtype and ``g`` in f32. On CUDA tensors it
launches the kernel or raises; on CPU tensors it computes the same
function with ``ff_dense_plain``, because the kernel cannot run there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Hinton's inter-layer normalization epsilon, shared by the kernel
# (csrc/ff_dense.cu), the plain version, the oracles and ff_mlp._norm.
NORM_EPS = 1e-8

# Calls that launched the CUDA kernel (2 CUDA launches each) in this
# process. chip_smoke.py zeroes it before the serving run and reads it
# after, to show the serving path went through the kernel.
LAUNCHES = 0

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


def _library():
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.ff_dense_launch.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
        lib.ff_dense_launch.restype = ctypes.c_int
        lib.ff_dense_block_n.argtypes = []
        lib.ff_dense_block_n.restype = ctypes.c_int
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


def ff_dense(x, w, b, *, norm=False):
    """x (M, K), w (K, N), b (N,) -> (y (M, N) in x.dtype, g (M,) f32).

    norm=True: y is returned as ``y / (sqrt(g) + NORM_EPS)``; g stays the
    raw pre-norm goodness. CUDA tensors launch the kernel (or raise);
    CPU tensors take ``ff_dense_plain``.
    """
    global LAUNCHES
    M, K, N = _check(x, w, b)
    if x.device.type == "cpu":
        return ff_dense_plain(x, w, b, norm=norm)
    if x.device.type != "cuda":
        raise ValueError(f"ff_dense runs on cuda or cpu tensors, got "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("ff_dense's kernel takes contiguous row-major "
                         "x, w and b")
    if M == 0 or K == 0 or N == 0:
        raise ValueError(f"ff_dense's kernel takes no empty dimension, got "
                         f"M={M}, K={K}, N={N}")
    lib = _library()
    dev = x.device
    n_blocks = -(-N // lib.ff_dense_block_n())
    with torch.cuda.device(dev):
        y = torch.empty((M, N), dtype=x.dtype, device=dev)
        g = torch.empty((M,), dtype=torch.float32, device=dev)
        gpart = torch.empty((n_blocks, M), dtype=torch.float32, device=dev)
        err = lib.ff_dense_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            g.data_ptr(), gpart.data_ptr(), M, K, N, int(norm),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ff_dense kernel launch failed: "
                           f"{lib.ff_dense_error_string(err).decode()}")
    LAUNCHES += 1
    return y, g
