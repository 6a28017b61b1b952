"""The whole step's share of the card's bf16 peak (989 TFLOP/s): the
model operations of the chapters that the window completed
(``yardstick.lm_chapter_flops``) over the window."""
from portbench.lib import yardstick as ys


def read(run):
    t = run.cell["traffic"]
    if run.unit != "tokens" or not run.chapters:
        return None
    flops = ys.lm_chapter_flops(run.cell["config"], t["batch"], t["seq"],
                                t["steps_per_chapter"])
    return 100.0 * flops * run.chapters / run.window_s / ys.BF16_PEAK
