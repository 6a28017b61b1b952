"""Small cells on the CPU, whole runs of the harness past its look for a
card, with the timed path sound or broken underneath:

    python portbench/tests/scenarios.py <driver> <case>

prints one JSON line: the run's ``correct`` and its numbers. Cases:
``sound``; ``unchanged`` (each grad step leaves the state as it was);
``half_batch`` (the loss over half of the batch, the mean over the
rest); ``control`` (the reference at the precision below the
configuration's, put in the program's place, judged by the cell's
limits).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import run as harness  # noqa: E402
from portbench.lib import cell as cell_lib, compare  # noqa: E402

CELLS = {"ff_mlp_chapters": "paper-mlp.full-batch.seq",
         "lm_chapters": "qwen2-0.5b.chapters.s512"}


def small_cell(driver):
    """The cell's files, with the sizes cut to what a test can hold."""
    cell = cell_lib.load(CELLS[driver])
    if driver == "ff_mlp_chapters":
        cell["config"]["layer_sizes"] = [784, 96, 96, 96]
        cell["traffic"]["data"]["n_train"] = 400
        cell["traffic"]["batch"] = 400
    else:
        cell["config"].update(num_layers=3, d_model=64, n_heads=4, n_kv=2,
                              head_dim=16, d_ff=128, vocab=512,
                              dtype="float32")
        cell["traffic"].update(batch=4, seq=32)
    return cell


def plant(driver, case):
    """Breaks the program underneath the harness."""
    if case == "unchanged":
        if driver == "ff_mlp_chapters":
            from repro_torch.core import ff_mlp
            ff_mlp.train_layer_chapter = lambda lp, opt, *a, **k: (lp, opt)
        else:
            from repro_torch.core import train
            train.adam_leaves = lambda *a, **k: None
    elif case == "half_batch":
        if driver == "ff_mlp_chapters":
            from repro_torch.core import ff_mlp
            loss = ff_mlp._ff_layer_loss

            def half(lp, xb, *a):
                h, q = xb.shape[0] // 2, xb.shape[0] // 4
                return loss(lp, xb[list(range(q)) + list(range(h, h + q))],
                            *a)
            ff_mlp._ff_layer_loss = half
        else:
            from repro_torch.core import ff
            masked = ff.ff_loss_masked

            def half(g, is_pos, theta):
                h, q = g.shape[0] // 2, g.shape[0] // 4
                rows = list(range(q)) + list(range(h, h + q))
                return masked(g[rows], is_pos[rows], theta)
            ff.ff_loss_masked = half


def main(driver, case):
    import importlib

    import torch

    torch.set_num_threads(1)
    harness.prepare()
    cell = small_cell(driver)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 11
    if case == "control":
        drv = importlib.import_module(f"portbench.drivers.{driver}")
        sess = drv.Session(cell, seed, dev, [])
        readings, data = sess.readings, sess.data
        reference = drv.follow(cell, seed, dev, readings, data)
        mode = next(iter(drv.CONTROLS))
        ctrl = drv.control_readings(cell, seed, dev, readings, data, mode)
        correct, checks = compare.judge(drv.numbers(ctrl, reference),
                                        cell["limits"])
    else:
        plant(driver, case)
        result, checks = harness.run_cell(cell, seed, 0.3, False, dev)
        correct = result["correct"]
    print(json.dumps({"correct": correct,
                      "numbers": {k: v["value"] for k, v in checks.items()}}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
