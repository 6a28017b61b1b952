"""Runs one cell of the PyTorch/CUDA port's benchmark once, on this
machine's cards:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is ``BENCHMARK.json``'s workload
entry and the files it names (``lib/cell.py``); its traffic file names
the driver (``drivers/<driver>.py``) that builds the program's training
object from the seed and runs its chapters.

Set-up builds the object and drives its first steps, which the
reference follows after the window. The window runs whole chapters
until ``--seconds`` have passed and ends at the end of the last one.
With ``--trace 1`` the window runs under ``torch.profiler`` and the
result holds the per-layer metrics (``metrics/<name>.py``), else the
end-to-end ones. Then the program's state is freed, the reference
follows the first steps from the same inputs and weights, and each
number compared is printed beside its limit, as the last lines of
standard error and under ``checks``, the last key of the JSON result
line that ends standard output.

It exits 2, printing no result, without as many CUDA cards as the cell
asks for, and 3 if JAX, flax or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
BANNED = ("jax", "jaxlib", "flax", "repro")


def prepare():
    """The program's source on the path, and every cache of the program
    at a fixed place inside the checkout."""
    os.environ["REPRO_TORCH_TUNE_TABLE"] = str(BENCH / "tune_table.json")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``repro_torch`` is the port's)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: dict
    unit: str
    work: float
    chapters: int
    window_s: float
    setup_s: float
    peak_bytes: int
    spans: list
    trace: dict = None
    calls: dict = dataclasses.field(default_factory=dict)


def window(sess, seconds, spans):
    """Whole chapters until ``seconds`` have passed: (work, chapters,
    seconds)."""
    spans.clear()
    work = chapters = 0
    t0 = time.perf_counter()
    while True:
        work += sess.chapter()
        chapters += 1
        if time.perf_counter() - t0 >= seconds:
            return work, chapters, time.perf_counter() - t0


def run_cell(cell, seed, seconds, trace, device, setup_t0=T_START):
    """One run of ``cell`` on ``device``: (result dict, checks)."""
    import torch
    from portbench.lib import compare, tracing

    driver = importlib.import_module(
        f"portbench.drivers.{cell['traffic']['driver']}")
    spans = []
    t0 = time.perf_counter()
    sess = driver.Session(cell, seed, device, spans)
    stages = {"before_session_s": t0 - setup_t0, **sess.stages,
              "session_s": time.perf_counter() - t0}
    print("setup tasks " + " ".join(f"{n}:{b - a:.3f}" for n, a, b in spans),
          file=sys.stderr)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - setup_t0
    calls, red = {}, None
    losses0 = len(getattr(sess, "losses", []))
    if trace:
        with tracing.profile() as prof, tracing.shapes_noted(calls):
            with torch.profiler.record_function(tracing.WINDOW):
                work, chapters, window_s = window(sess, seconds, spans)
    else:
        work, chapters, window_s = window(sess, seconds, spans)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(1 for v in getattr(sess, "losses", [])[losses0:] if v != v)
    found = banned_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        sys.exit(3)
    if trace:
        red = tracing.reduce(tracing.events(prof), cell["chips"])
        del prof
    run = Run(cell=cell, unit=sess.unit, work=work, chapters=chapters,
              window_s=window_s, setup_s=setup_s, peak_bytes=peak,
              spans=spans, trace=red, calls=calls)
    readings, data = sess.readings, sess.data
    sess.free()
    del sess
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check(cell, seed, device, readings, data)
    correct, checks = compare.judge(numbers, cell["limits"])
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": chapters, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if red is not None:
        result["device"].update(busy_s=red["busy_s"],
                                window_s=red["window_s"])
        result["breakdown"] = red["breakdown"]
    result["checks"] = checks
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          file=sys.stderr)
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    from portbench.lib import cell as cell_lib

    cell = cell_lib.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
