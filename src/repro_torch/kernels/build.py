"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each kernel source under ``kernels/*/csrc/`` has a plain C interface. At
first use it is compiled for Hopper (``sm_90a``) into a shared library in
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named after a hash of the source, the shared headers in ``kernels/csrc/``
and the flags, so that an edited source or header rebuilds. Builds of several sources start together, one nvcc each.

Nothing here runs at import time, and nothing falls back: a missing nvcc,
a failed compile or a failed load raises `KernelCompileError`, marked not
retriable (depth is a runtime argument, so every depth builds the same
source) and refused (no kernel ran). A failed build is not cached.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.core.guard import KernelCompileError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "library_path", "load"]

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
HEADER_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, shared memory, spills) of each build this process ran
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelCompileError("nvcc not found on PATH or in the CUDA toolkit",
                             kernel="build", refused=True, retriable=False)


def library_path(source: Path) -> Path:
    """Where the library built from `source` lives (content-addressed: the
    source, the shared headers of ``kernels/csrc/`` and the flags)."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in sorted(HEADER_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, all nvcc processes
    started together. Returns {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[Path, Path] = {}
    running = []
    for src in sources:
        src = Path(src)
        lib = library_path(src)
        out[src] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in running:
        log, _ = proc.communicate()
        build_logs[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
    if failed:
        raise KernelCompileError("nvcc failed: " + "\n".join(failed),
                                 kernel="build", refused=True,
                                 retriable=False)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    source = Path(source)
    key = str(source)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = build([source])[source]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelCompileError(f"cannot load {path}: {e}",
                                         kernel=source.stem, refused=True,
                                         retriable=False) from e
            _loaded[key] = lib
        return lib
