"""Build the port's CUDA sources and load them with ctypes.

Each ``convdr_torch/csrc/<name>.cu`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into ``convdr_torch/build/lib<name>-<hash>.so``
at first use (the hash covers the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header never loads a stale library)
and opened with :mod:`ctypes`. Nothing here runs at import time: the CPU
tests import every module on a machine with no
``nvcc``. ``nvcc -Xptxas -v`` reports each kernel's registers, shared memory
and spills; the report is kept beside the library (:func:`ptxas_report`).
:func:`bind` and :func:`launch` keep a wrapper's host work per call small:
a C entry's ``argtypes`` are set once, when it is first bound, and the
stream is the device's current raw handle, with no ``Stream`` object and
no device switch unless the tensor's device is not the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Any] = {}


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
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header of csrc/, which it may include
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
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


def bind(name: str, symbol: str, argtypes: Sequence[Any], restype: Any = ctypes.c_int):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ``argtypes``
    and ``restype`` set, built and bound on first use and cached."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[(name, symbol)] = fn
    return fn


def launch(fn, device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream; returns the C
    entry's code (a ``cudaError_t``). The device is made current only for
    the call, and only when it is not already."""
    index = device.index
    if torch._C._cuda_getDevice() != index:
        with torch.cuda.device(index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def ptxas_report(name: str) -> List[str]:
    """``ptxas`` lines (registers, shared memory, stack frame and spills) of
    a built source."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [ln.rstrip() for ln in f if "ptxas" in ln or "spill" in ln]
