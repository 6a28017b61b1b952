"""``ff_dense_bwd``'s share of its roofline, counting the products the
caller uses: every caller in these cells trains one layer on inputs
that need no gradient, so dw and db and not dx
(``yardstick.ff_dense_bwd_roofline_s(need_dx=False)``), over the summed
time of its kernels in the traced window."""
from portbench.lib import tracing, yardstick as ys


def read(run):
    calls = run.calls.get("ff_dense_bwd")
    if run.trace is None or not calls:
        return None
    spent = sum(run.trace["kernel_s"].get(k, 0.0)
                for k in tracing.KERNELS["ff_dense_bwd"])
    if spent <= 0:
        return None
    least = sum(ys.ff_dense_bwd_roofline_s(M, K, N, False, size)
                for M, K, N, size in calls)
    return 100.0 * least / spent
