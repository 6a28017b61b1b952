"""What the benchmark loads, and that it runs only on a card.

A fresh interpreter imports the harness, every driver, every metric
reader and the references: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (whole names: the port's
``repro_torch`` begins with ``repro``) may be loaded, and the references
alone load nothing of ``repro_torch`` either."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV_FREE = {"PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}

LOAD_ALL = f"""
import importlib, json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "src")!r}]
from portbench import run
from pathlib import Path
mods = [p.stem for p in Path({str(ROOT / "portbench")!r}).glob("*/*.py")]
for sub in ("lib", "drivers", "reference"):
    for p in Path({str(ROOT / "portbench")!r}, sub).glob("*.py"):
        importlib.import_module(f"portbench.{{sub}}.{{p.stem}}")
for p in Path({str(ROOT / "portbench" / "metrics")!r}).glob("*.py"):
    run.reader(p.stem)
import repro_torch.core.pff, repro_torch.core.pff_lm
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import portbench.reference.ff_mlp, portbench.reference.lm
import portbench.lib.weights, portbench.lib.traffic, portbench.lib.compare
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**_env(), **ENV_FREE})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _env():
    import os
    return dict(os.environ)


def test_the_harness_loads_no_jax_and_no_jax_package():
    loaded = _top_level(LOAD_ALL)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(LOAD_REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_refuses_to_run_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "paper-mlp.full-batch.seq", "--seed", "2147483999", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120, env={**_env(), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_harness_refuses_to_run_without_the_program(tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "paper-mlp.full-batch.seq", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=120, env={**_env(), "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
