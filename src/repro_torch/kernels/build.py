"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under ``build/kernels/``
at the repository root (listed in ``.gitignore``).  The library name carries
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  ``ptxas`` reports each kernel's registers, shared
memory and spills (``-Xptxas -v``); :func:`ptxas_report` returns that
report of a built library.  Nothing is built when this module is imported:
:func:`library` builds on first use.  Each name has its own lock, so
threads that ask for different libraries run their ``nvcc`` at once
(``chip_smoke.py`` builds every source so).
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The shared library of ``csrc/<name>.cu`` (built or not): its name
    carries a hash of the source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    target.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, target)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            target = library_path(name)
            if not target.exists():
                _compile(name, target)
            _loaded[name] = ctypes.CDLL(str(target))
        return _loaded[name]


def ptxas_report(name: str) -> list[str]:
    """The ``ptxas`` lines of a built ``csrc/<name>.cu``: per kernel, its
    name, then its registers, shared memory and spill bytes."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        raise RuntimeError(f"{name}.cu has no build log: build it first")
    return [line.strip() for line in log.read_text().splitlines()
            if "Compiling entry" in line or "spill" in line
            or ("ptxas info" in line and "Used" in line)]
