"""Build the port's CUDA sources and load them with ctypes.

Each ``convdr_torch/csrc/<name>.cu`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into ``convdr_torch/build/lib<name>-<hash>.so``
at first use (the hash covers the source and the flags, so an edited source
never loads a stale library) and opened with :mod:`ctypes`. Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``. ``nvcc -Xptxas -v`` reports each kernel's registers, shared memory
and spills; the report is kept beside the library (:func:`ptxas_report`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built from convdr_torch/csrc"
    )


def _paths(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}-{digest.hexdigest()[:12]}"
    return src, os.path.join(BUILD_DIR, stem + ".so"), os.path.join(
        BUILD_DIR, stem + ".ptxas.txt"
    )


def _tmp(so: str) -> str:
    return f"{so}.{os.getpid()}.tmp"


def _start(name: str) -> Optional[subprocess.Popen]:
    src, so, _log = _paths(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", _tmp(so), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, all at once (one
    ``nvcc`` process per source, started together), and raise with the
    compiler's output if any fails."""
    names = list(names)
    procs = {name: _start(name) for name in names}
    failed: List[str] = []
    for name, proc in procs.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        _src, so, log = _paths(name)
        tmp = _tmp(so)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        with open(log, "w") as f:
            f.write(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> List[str]:
    """``ptxas`` lines (registers, shared memory, spills) of a built source."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [ln.rstrip() for ln in f if "ptxas" in ln]
