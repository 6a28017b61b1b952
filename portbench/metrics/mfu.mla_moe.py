"""The whole step's share of the card's bf16 peak (989 TFLOP/s): the
model operations of the chapters that the window completed
(``yardstick_mla_moe.chapter_flops``: the routed experts at the
deployment's even load, E_h / E of the choices, whatever the router
did) over the window."""
from portbench.lib import yardstick as ys
from portbench.lib import yardstick_mla_moe as ym


def read(run):
    c, t = run.cell["config"], run.cell["traffic"]
    if run.unit != "tokens" or not run.chapters or "kv_lora_rank" not in c:
        return None
    flops = ym.chapter_flops(c, t["batch"], t["seq"], t["steps_per_chapter"])
    return 100.0 * flops * run.chapters / run.window_s / ys.BF16_PEAK
