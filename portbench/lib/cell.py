"""A cell, found by its name: ``BENCHMARK.json``'s workload entry, its
configuration's file, its traffic file and its limits file.

- ``configs/<config>.json``: the sizes as they are run;
- ``traffic/<traffic>.json``: the driver (``drivers/<driver>.py``), the
  generator's sizes (``lib/traffic.py``), the batch and the schedule;
- ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from.

A new cell is new files and entries; no file here names a cell.
"""
from __future__ import annotations

import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _read(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _read(Path(root) / "BENCHMARK.json")


def load(workload, root=ROOT):
    """{"name", "chips", "config", "traffic", "limits", "end_to_end",
    "per_layer"}: the workload's files, and the metrics that its cell
    reports (a metric without ``workloads`` is reported by every cell)."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(Path(root) / configs[entry["config"]]["file"])
    traffic = _read(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = _read(BENCH_DIR / "cells" / f"{workload}.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"name": workload, "chips": entry["chips"], "config": config,
            "traffic": traffic, "limits": limits["limits"],
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}
