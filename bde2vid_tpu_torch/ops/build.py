"""Build and load the hand-written CUDA kernels.

Each source under ``ops/csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
is loaded with ``ctypes``. Libraries go to ``<repo>/build/kernels/``, named
by a hash of their source, and are built at first use. Nothing here runs at
import time: machines without the CUDA toolkit have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"swin_block": _CSRC / "swin_block.cu", "attn_core_bwd": _CSRC / "attn_core_bwd.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_reports: Dict[str, str] = {}  # nvcc output (register/spill counts) of each build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha1(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: List[str] | None = None) -> Dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Raises with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it first if needed."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
