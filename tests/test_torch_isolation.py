"""The port stands alone: importing every ``repro_torch`` module loads no
JAX and no module of the reference package ``repro`` (checked in a
fresh interpreter), no source line of the port or of ``chip_smoke.py``
imports either, and the entry points refuse to fall back to the CPU by
themselves when no CUDA device is present."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch import api, data
from repro_torch.configs.ff_mlp import FFMLPConfig
from repro_torch.convert import tree_leaves
from repro_torch.core import ff_mlp
from repro_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked, ",".join(names))
sys.exit(1 if leaked else 0)
"""

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)",
                        re.MULTILINE)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 19                         # the slice's modules
    # the train-while-serve and LM-training slice's modules among them
    names = set(proc.stdout.split()[-1].split(","))
    assert {"repro_torch.core.train", "repro_torch.core.pff_lm",
            "repro_torch.data.encoder", "repro_torch.kernels.guard",
            "repro_torch.kernels.counts", "repro_torch.serve.engine",
            "repro_torch.launch.serve"} <= names


def test_no_source_line_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 19
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
    # the pattern itself catches what it must and spares the port
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import ff")
    assert _FORBIDDEN.search("import repro")
    assert not _FORBIDDEN.search("from repro_torch.core import ff")


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_entry_points_do_not_carry_on_on_the_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = FFMLPConfig(layer_sizes=(784, 16))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ff_mlp.init(cfg, gen)
    params = ff_mlp.init(cfg, gen, "cpu")
    assert params["layers"][0]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(cfg, data.mnist_like(n_train=8, n_test=8), params=params)
    # train-while-serve and LM chapter training
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(cfg, data.mnist_like(n_train=8, n_test=8))
    from repro_torch.configs import get_config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.fit(get_config("qwen2-0.5b").reduced(), None, chapters=1,
                steps_per_chapter=1, seq=8)


def test_init_caches_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    _no_cuda(monkeypatch)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_caches(cfg, 1, 8)
    caches = transformer.init_caches(cfg, 1, 8, device="cpu")
    assert {t.device.type for t in tree_leaves(caches)} == {"cpu"}
