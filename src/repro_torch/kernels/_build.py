"""Build the port's CUDA sources into one shared library at first use.

Every ``*.cu`` under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a plain-C shared library (no PyTorch headers, so the
build takes seconds) and loaded with ``ctypes``. The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged
one is reused. Nothing is built or loaded at import: the CPU tests
import every module on a machine with no ``nvcc``.

Each kernel module binds its own entry points (``argtypes`` and
``restype``) on the ``ctypes.CDLL`` that ``load()`` returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # per-kernel registers, shared memory and spills, kept in
              # the build log beside the library
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else in ``$CUDA_HOME/bin``, else in
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base and (Path(base) / "bin" / "nvcc").is_file():
            return str(Path(base) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        "/usr/local/cuda/bin: the port's CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns
    its path. The output is written under a temporary name and renamed,
    so concurrent builders never load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """The compiler's output for the current library ('' if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per
    process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
