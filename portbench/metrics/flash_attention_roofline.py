"""``flash_attention``'s share of its roofline: the summed least time of
its calls in the traced window (``yardstick.flash_attention_roofline_s``
over the visible pairs) over the summed time of its kernels."""
from portbench.lib import tracing, yardstick as ys


def read(run):
    calls = run.calls.get("flash_attention")
    if run.trace is None or not calls:
        return None
    spent = sum(run.trace["kernel_s"].get(k, 0.0)
                for k in tracing.KERNELS["flash_attention"])
    if spent <= 0:
        return None
    least = sum(ys.flash_attention_roofline_s(B, Sq, Sk, H, KV, hd, causal,
                                              size, window)
                for B, Sq, Sk, H, KV, hd, causal, size, window in calls)
    return 100.0 * least / spent
