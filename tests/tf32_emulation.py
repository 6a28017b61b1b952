"""The port's tensor-core arithmetic, emulated in torch on the CPU.

``csrc/ff_dense.cu`` and ``csrc/mamba2_ssd.cu`` multiply f32 operands
on ``mma.sync.m16n8k8`` with TF32 inputs and f32 accumulation, as
3xTF32 (``csrc/tc_common.cuh``): each operand is split into
``hi = tf32(a)`` and ``lo = tf32(a - hi)``, and every 8-deep step of the
reduction multiplies ``lo.hi``, then ``hi.lo``, then ``hi.hi`` into a
fresh fragment that is then added to the f32 accumulator. The tests hold
this arithmetic, in the kernels' order, against the reference's Pallas
kernels at the reference's tolerances.

By default each product and sum here rounds to nearest, as the CPU
does. That does not reproduce the card's own accumulation: the tensor
cores truncate each mma's sum toward zero. ``rz=True`` models that as
one round toward zero of the exact sum per mma; the hardware may drop
more bits than this model (it aligns the products before adding them),
so the model gives the bias's order, not the card's digits."""
import torch


def tf32(t):
    """TF32 rounding as the kernels do it (the rounding of
    ``cvt.rna.tf32.f32``: nearest, ties away from zero), on the f32 bits:
    add half a unit of the 10 kept mantissa bits to the magnitude, then
    clear the 13 dropped bits."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma(c, a, b, rz):
    """c + a @ b for one 8-deep step: rounded to nearest, or (``rz``) the
    exact sum rounded toward zero, as a tensor-core mma does."""
    if not rz:
        return c + a @ b
    exact = c.double() + a.double() @ b.double()
    r = exact.float()
    over = r.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mm_tf32(a, b, products=3, *, fresh=True, rz=False):
    """a (..., M, K) @ b (..., K, N) in f32 as the kernels accumulate it:
    K in steps of 8 (the last one zero-padded). ``products=3`` (3xTF32):
    each step's ``lo.hi + hi.lo + hi.hi`` into a fresh fragment, added to
    the running f32 sum to nearest; ``fresh=False`` chains the three
    products straight into the running sum instead, as the kernels did
    before they took the fresh fragment. ``products=1``: ``hi.hi`` alone,
    straight into the running sum (the bf16 path of ff_dense). ``rz``:
    see the module note."""
    a, b = a.float(), b.float()
    acc = torch.zeros(*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
                      a.shape[-2], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = tf32(ak), tf32(bk)
        if products == 1:
            acc = _mma(acc, ah, bh, rz)
            continue
        f = torch.zeros_like(acc) if fresh else acc
        f = _mma(f, tf32(ak - ah), bh, rz)
        f = _mma(f, ah, tf32(bk - bh), rz)
        f = _mma(f, ah, bh, rz)
        acc = acc + f if fresh else f
    return acc
