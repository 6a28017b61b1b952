"""``ff_dense``'s share of its roofline: the summed least time of its
calls in the traced window (``yardstick.ff_dense_roofline_s``: products
at the 3xTF32 rate for f32) over the summed time of its kernels."""
from portbench.lib import tracing, yardstick as ys


def read(run):
    calls = run.calls.get("ff_dense")
    if run.trace is None or not calls:
        return None
    spent = sum(run.trace["kernel_s"].get(k, 0.0)
                for k in tracing.KERNELS["ff_dense"])
    if spent <= 0:
        return None
    least = sum(ys.ff_dense_roofline_s(M, K, N, norm, size)
                for M, K, N, norm, size in calls)
    return 100.0 * least / spent
