"""The whole step's share of the card's peak for f32-exact products
(3xTF32: 495 / 3 TFLOP/s): the model operations of the chapters that
the window completed (``yardstick.mlp_chapter_flops``) over the
window."""
from portbench.lib import yardstick as ys


def read(run):
    c, t = run.cell["config"], run.cell["traffic"]
    if run.unit != "samples" or not run.chapters:
        return None
    n = t["data"]["n_train"]
    steps = -(-n // t["batch"]) * max(c["epochs"] // c["splits"], 1)
    flops = ys.mlp_chapter_flops(c["layer_sizes"], t["batch"], n,
                                 c["num_classes"], steps)
    return 100.0 * flops * run.chapters / run.window_s / ys.F32X3_PEAK
