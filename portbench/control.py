"""The readings that the limits of ``correct`` are set from, on a card:

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--controls tf32,half_batch] [--out <file>]

For each seed: the program's set-up with its first steps (no window:
training's readings need none), the reference from the same inputs, and
the cell's numbers; then each control (the reference put in the
program's place at the precision below the configuration's) and each
planted fault (``half_batch``: half of the batch left out), judged by
the same numbers against the same reference. The benchmark's runs never
run this. One JSON line per reading on standard output, and every line
in ``--out`` as a list.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import run as harness  # noqa: E402


def readings_for(cell, seed, device, controls):
    import torch

    driver = importlib.import_module(
        f"portbench.drivers.{cell['traffic']['driver']}")
    sess = driver.Session(cell, seed, device, [])
    readings, data = sess.readings, sess.data
    sess.free()
    del sess
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = driver.follow(cell, seed, device, readings, data)
    out = [{"seed": seed, "side": "program",
            "numbers": driver.numbers(readings, reference)}]
    for mode in controls:
        ctrl = driver.control_readings(cell, seed, device, readings, data,
                                       mode)
        out.append({"seed": seed, "side": mode,
                    "numbers": driver.numbers(ctrl, reference)})
        del ctrl
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.prepare()
    import torch
    from portbench.lib import cell as cell_lib

    cell = cell_lib.load(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = [c for c in args.controls.split(",") if c]
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings_for(cell, seed, device, controls):
            line["workload"] = args.workload
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
