"""Trainable fused FF layer: the backward of ``ff_dense`` and the two
``torch.autograd.Function``s that make the kernel path differentiable.

The port of ``repro/kernels/ff_dense_vjp.py``. With y = relu(x @ w + b)
and g = sum(y^2, -1), the cotangents (dy_out, dg) combine into

    dy = (dy_out + 2 * y * dg[:, None])   where y > 0, else 0

and dx = dy @ w^T, dw = x^T @ dy, db = sum_rows(dy). ``ff_dense_bwd``
computes all three with the hand-written CUDA kernel in
``csrc/ff_dense_bwd.cu``, whose header gives its design and bound: three
CUDA launches per call (``grad_x`` over S slices of N into an (S, M, K)
scratch, ``sum_slices`` adding them in slice order into dx, ``grad_w``
with db), f32 FMA from a 2-stage ``cp.async`` ring, dy rebuilt in shared
memory from the raw y and dy_out tiles and never written to device
memory. ``_grad_x_split`` picks S. ``LAUNCHES`` counts calls. CPU
tensors take ``ff_dense_bwd_plain``, because the kernel cannot run
there.

``ff_dense_vjp(x, w, b)`` and ``ff_dense_norm_vjp(x, w, b)`` are the
reference's two custom_vjps: the forward is the ``ff_dense`` kernel
(``kernels.ff_dense.ff_dense``, norm off / on), the backward is
``ff_dense_bwd``. The norm backward folds its cotangents into the same
kernel's ``(dy_out, dg)`` form with O(M*N) elementwise work, exactly as
the reference's ``_ff_dense_norm_vjp_bwd`` does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import counts, ff_dense as ff_dense_kernel
from repro_torch.kernels.ff_dense import NORM_EPS

# Calls that launched the CUDA backward kernel (3 CUDA launches each) in
# this process. chip_smoke.py zeroes it before a training run and reads
# it after, to show every grad step went through the kernel.
LAUNCHES = counts.Counter()     # launched calls, by thread

# grad_x's block tile (m rows, k columns) and stage depth (n), as in
# csrc/ff_dense_bwd.cu.
GRAD_X_BM, GRAD_X_BN, GRAD_X_BK = 128, 64, 16
# grad_x blocks wanted: two on each of the H100's 132 SMs (its registers
# hold three at a time, so one wave takes them all).
GRAD_X_BLOCKS = 2 * 132
# n columns a slice covers at least: 8 stages, so that a slice's loop is
# long against the ring's fill.
GRAD_X_MIN_SLICE = 128
# The launch bits of ff_dense_bwd_launch: grad_x, sum_slices, grad_w.
GRAD_X, SUM_SLICES, GRAD_W = 1, 2, 4

_lib = None


def ff_dense_bwd_plain(x, w, y, dy_out, dg):
    """The plain PyTorch version, in the reference's op order: rebuild
    dy with a select (never a mask product: dg may be NaN on a dead
    row), then the three products."""
    dy = dy_out.float() + 2.0 * y.float() * dg[:, None]
    dy = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                            device=dy.device))
    dx = (dy @ w.float().T).to(x.dtype)
    dw = (x.float().T @ dy).to(w.dtype)
    return dx, dw, torch.sum(dy, dim=0)


def _grad_x_split(M, K, N):
    """(S, L): grad_x splits dx's reduction over N into S slices of L
    columns, [s*L, min((s+1)*L, N)), each non-empty and L a multiple of
    the stage depth, so that its (K/64) * (M/128) * S blocks come near
    ``GRAD_X_BLOCKS`` without a slice shorter than ``GRAD_X_MIN_SLICE``
    (when N allows): 256 blocks at (128, 2000, 2000), 208 at K 784."""
    tiles = -(-K // GRAD_X_BN) * -(-M // GRAD_X_BM)
    want = max(1, round(GRAD_X_BLOCKS / tiles))
    slices = max(1, min(want, -(-N // GRAD_X_MIN_SLICE)))
    L = -(-(-(-N // slices)) // GRAD_X_BK) * GRAD_X_BK
    return -(-N // L), L


def _library():
    """The kernel library with the backward's entry bound (the forward's
    module binds the shared ``ff_dense_error_string``)."""
    global _lib
    if _lib is None:
        lib = ff_dense_kernel._library()
        lib.ff_dense_bwd_launch.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int] * 6
                                            + [ctypes.c_void_p])
        lib.ff_dense_bwd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, w, y, dy_out, dg):
    """Shapes, dtypes and devices the kernel takes; returns (M, K, N)."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"ff_dense_bwd expects x (M, K), w (K, N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    (M, K), (K2, N) = x.shape, w.shape
    if (K2 != K or tuple(y.shape) != (M, N)
            or tuple(dy_out.shape) != (M, N) or tuple(dg.shape) != (M,)):
        raise ValueError(
            f"ff_dense_bwd shape mismatch: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, y {tuple(y.shape)}, dy_out "
            f"{tuple(dy_out.shape)}, dg {tuple(dg.shape)}")
    dtypes = {t.dtype for t in (x, w, y, dy_out, dg)}
    if dtypes != {torch.float32}:
        raise TypeError(f"ff_dense_bwd takes float32 operands only (the "
                        f"training path is f32); got "
                        f"{sorted(str(d) for d in dtypes)}")
    devices = {t.device for t in (x, w, y, dy_out, dg)}
    if len(devices) != 1:
        raise ValueError(f"ff_dense_bwd operands on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    return M, K, N


def _launch(x, w, y, dy_out, dg, parts=GRAD_X | SUM_SLICES | GRAD_W):
    """Launches the kernel's parts named by the bits of ``parts`` on CUDA
    operands that ``_check`` passed; returns (dx, dw, db). Only all three
    parts make all three outputs: a single part is launched to time it."""
    M, K, N = x.shape[0], x.shape[1], w.shape[1]
    if not all(t.is_contiguous() for t in (x, w, y, dy_out, dg)):
        raise ValueError("ff_dense_bwd's kernel takes contiguous "
                         "row-major operands")
    if M == 0 or K == 0 or N == 0:
        raise ValueError(f"ff_dense_bwd's kernel takes no empty dimension, "
                         f"got M={M}, K={K}, N={N}")
    S, L = _grad_x_split(M, K, N)
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        dx = torch.empty((M, K), dtype=torch.float32, device=dev)
        dw = torch.empty((K, N), dtype=torch.float32, device=dev)
        db = torch.empty((N,), dtype=torch.float32, device=dev)
        part = torch.empty((S, M, K), dtype=torch.float32, device=dev)
        err = lib.ff_dense_bwd_launch(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), dy_out.data_ptr(),
            dg.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), M, K, N, S, L, parts,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ff_dense_bwd kernel launch failed: "
                           f"{lib.ff_dense_error_string(err).decode()}")
    return dx, dw, db


def ff_dense_bwd(x, w, y, dy_out, dg):
    """(x (M, K), w (K, N), y (M, N), dL/dy (M, N), dL/dg (M,)) ->
    (dx (M, K), dw (K, N), db (N,)), all f32.

    CUDA tensors launch the kernel (three CUDA launches, or raise); CPU
    tensors take ``ff_dense_bwd_plain``.
    """
    _check(x, w, y, dy_out, dg)
    if x.device.type == "cpu":
        return ff_dense_bwd_plain(x, w, y, dy_out, dg)
    if x.device.type != "cuda":
        raise ValueError(f"ff_dense_bwd runs on cuda or cpu tensors, got "
                         f"{x.device}")
    out = _launch(x, w, y, dy_out, dg)
    LAUNCHES.bump()
    return out


class FFDense(torch.autograd.Function):
    """(x, w, b) -> (y, g) through the ``ff_dense`` kernel; the backward
    is ``ff_dense_bwd``. Unused outputs get autograd's materialized zero
    cotangents (sumsq with peer_w = 0 uses no y)."""

    @staticmethod
    def forward(ctx, x, w, b):
        y, g = ff_dense_kernel.ff_dense(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.b_dtype = b.dtype
        return y, g

    @staticmethod
    def backward(ctx, dy_out, dg):
        x, w, y = ctx.saved_tensors
        dx, dw, db = ff_dense_bwd(x, w, y, dy_out.contiguous(),
                                  dg.contiguous())
        return dx, dw, db.to(ctx.b_dtype)


class FFDenseNorm(torch.autograd.Function):
    """(x, w, b) -> (yn = y / (sqrt(g) + eps), raw g) through the
    ``ff_dense`` kernel's norm epilogue.

    Backward, as the reference derives it: with s = sqrt(g) and
    u = 1 / (s + eps), the normalizer's chain rule folds the cotangents
    (dyn, dg) into ``dy_out' = dyn * u`` and
    ``dg' = dg - (dyn . y) * u^2 / (2s)``, and ``ff_dense_bwd`` runs on
    them with the raw ``y = yn * (s + eps)``. On an all-dead row (g = 0)
    dg' is 0/0 = NaN; the kernel's select on y > 0 drops it, so such a
    row gets an exact zero gradient (perf_opt uses no g: its dg is the
    materialized zero)."""

    @staticmethod
    def forward(ctx, x, w, b):
        yn, g = ff_dense_kernel.ff_dense(x, w, b, norm=True)
        ctx.save_for_backward(x, w, yn, g)
        ctx.b_dtype = b.dtype
        return yn, g

    @staticmethod
    def backward(ctx, dyn, dg):
        x, w, yn, g = ctx.saved_tensors
        dyn = dyn.contiguous()
        s = torch.sqrt(g)
        u = 1.0 / (s + NORM_EPS)
        scale = s + NORM_EPS
        y = yn * scale[:, None]
        rowdot = torch.sum(dyn * yn, dim=-1) * scale        # = dyn . y
        dg_eff = dg - rowdot * u * u / (2.0 * s)
        dy_out_eff = dyn * u[:, None]
        dx, dw, db = ff_dense_bwd(x, w, y, dy_out_eff, dg_eff.contiguous())
        return dx, dw, db.to(ctx.b_dtype)


def ff_dense_vjp(x, w, b):
    """Differentiable fused FF layer: (y (M, N), goodness (M,))."""
    return FFDense.apply(x, w, b)


def ff_dense_norm_vjp(x, w, b):
    """Differentiable fused FF layer with the norm epilogue:
    (yn (M, N) length-normalized, RAW goodness (M,))."""
    return FFDenseNorm.apply(x, w, b)
