"""The whole step's share of four cards' peak for f32-exact products
(4 x 3xTF32: 4 x 495 / 3 TFLOP/s): the model operations of the chapters
that the window completed (``yardstick.mlp_chapter_flops``, each
executor run ``chapters_per_call`` chapters) over the window."""
from portbench.lib import yardstick as ys


def read(run):
    c, t = run.cell["config"], run.cell["traffic"]
    if run.unit != "samples" or not run.chapters or \
            "chapters_per_call" not in t:
        return None
    n = t["data"]["n_train"]
    steps = -(-n // t["batch"]) * max(c["epochs"] // c["splits"], 1)
    flops = ys.mlp_chapter_flops(c["layer_sizes"], t["batch"], n,
                                 c["num_classes"], steps)
    chapters = run.chapters * t["chapters_per_call"]
    return 100.0 * flops * chapters / run.window_s / (
        run.cell["chips"] * ys.F32X3_PEAK)
