"""ctypes bindings for the port's C++ host library (``csrc/host/convdr_native.cpp``).

The counterpart of ``convdr_tpu/native_io.py``: the native embedding-block
store (``.cnb`` files), the token-cache split merge, the row gather from a
flat on-disk payload and the host top-k merge, with the same C entry points,
the same 32-byte header and the same dtype codes (0 f32, 1 bf16, 2 int8).

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` into ``convdr_torch/build/libconvdr_native-<hash>.so``; the hash
covers the source and the flags, so an edited source never loads a stale
library. No ``-march=native``: one build directory may serve two machines.
The HNSW graph (``csrc/host/hnsw.cpp``, a copy of the JAX package's
``native/hnsw.cpp``) is a second library, ``libconvdr_hnsw-<hash>.so``,
built by the same rules with the JAX package's Makefile flags
(:data:`HNSW_CXX_FLAGS`, ``-march=native`` included); its hash also covers
the CPU, so it is rebuilt on a machine with another one.

Each native entry point has a separate numpy version, ``<name>_plain``,
with the same contract (the same bytes on disk, the same arrays back); the
tests hold one to the other. The native entry points never fall back to
the plain versions: when the library cannot be built or loaded they raise
with the compiler's output. Nothing here imports ``torch``: the tokenize
pipeline's spawned workers import this module's package.

The block store and the split merge serve the data plane today. The row
gather and the host top-k merge have no caller in the port yet: the row
gather is what the JAX package's rescore-from-file (``retrieval/refine.py``,
ROADMAP Slice D) reads candidates with, and the host merge completes the
JAX module's interface; both are held to the JAX package's in the tests.

Native block files (``.cnb``) hold a 32-byte header (magic, rows, dim,
dtype code as 64-bit words), the contiguous rows, then the int64 ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PKG_DIR, "csrc", "host", "convdr_native.cpp")
HNSW_SOURCE = os.path.join(PKG_DIR, "csrc", "host", "hnsw.cpp")
ZSTD_SOURCE = os.path.join(PKG_DIR, "csrc", "host", "zstd.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# the JAX package's Makefile flags: floating-point contraction and unrolling
# shape the distances HNSW compares, so both packages build the same graph
# from the same rows only when both compile it alike
HNSW_CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17", "-fPIC",
                  "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_hnsw_lib: Optional[ctypes.CDLL] = None
_zstd_lib: Optional[ctypes.CDLL] = None

_HEADER_BYTES = 32
_MAGIC = 0x434E5642304B4C42

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "convdr_write_block_ex": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
    ]),
    "convdr_read_block_header_ex": (ctypes.c_int, [
        ctypes.c_char_p, _I64P, _I64P, _I64P,
    ]),
    "convdr_read_block_ex": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int,
    ]),
    "convdr_merge_splits": (ctypes.c_int64, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int64, _I64P, ctypes.c_int64,
    ]),
    "convdr_gather_rows": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _I64P, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]),
    "convdr_merge_topk": (None, [
        _F32P, _I64P, _F32P, _I64P, ctypes.c_int64, ctypes.c_int64, _F32P, _I64P,
    ]),
}
_I64 = ctypes.c_int64
_HNSW_SIGNATURES = {
    "convdr_hnsw_create": (ctypes.c_void_p, [_I64, _I64, _I64, _I64, ctypes.c_uint64]),
    "convdr_hnsw_free": (None, [ctypes.c_void_p]),
    "convdr_hnsw_add": (None, [ctypes.c_void_p, _F32P, _I64]),
    "convdr_hnsw_add_parallel": (None, [ctypes.c_void_p, _F32P, _I64, _I64]),
    "convdr_hnsw_size": (_I64, [ctypes.c_void_p]),
    "convdr_hnsw_set_ef_search": (None, [ctypes.c_void_p, _I64]),
    "convdr_hnsw_search": (None, [ctypes.c_void_p, _F32P, _I64, _I64, _F32P, _I64P]),
    "convdr_hnsw_search_parallel": (None, [
        ctypes.c_void_p, _F32P, _I64, _I64, _F32P, _I64P, _I64,
    ]),
}
_ZSTD_SIGNATURES = {
    "zstd_decompress": (_I64, [ctypes.c_void_p, _I64, ctypes.c_void_p, _I64]),
    "zstd_content_size": (_I64, [ctypes.c_void_p, _I64]),
    "zstd_compress_raw": (_I64, [ctypes.c_void_p, _I64, ctypes.c_void_p, _I64]),
    "zstd_error_name": (ctypes.c_char_p, [_I64]),
    "convdr_crc32c": (ctypes.c_uint32, [ctypes.c_void_p, _I64, ctypes.c_uint32]),
}


def _cpu_fingerprint() -> bytes:
    """The host CPU's model and feature flags: a ``-march=native`` library
    is only loaded on a CPU like the one that built it."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f if ln.startswith((b"model name", b"flags"))]
        return b"".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def _library_path(stem: str, source: str, flags, native: bool = False) -> str:
    """``build/<stem>-<hash>.so``: the hash covers the source, the flags and,
    for a ``-march=native`` build, the CPU."""
    digest = hashlib.sha1(" ".join(flags).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    if native:
        digest.update(_cpu_fingerprint())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def library_path() -> str:
    return _library_path("libconvdr_native", SOURCE, CXX_FLAGS)


def hnsw_library_path() -> str:
    return _library_path("libconvdr_hnsw", HNSW_SOURCE, HNSW_CXX_FLAGS, native=True)


def zstd_library_path() -> str:
    return _library_path("libconvdr_zstd", ZSTD_SOURCE, CXX_FLAGS)


def _build(so: str, source: str = SOURCE, flags=CXX_FLAGS) -> None:
    """g++ ``source`` into a temporary name, then rename it to ``so``;
    raises with the compiler's output if it fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", *flags, "-o", tmp, source],
            capture_output=True, text=True,
        )
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {source}: g++ not found") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"g++ failed to build {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)


def _open(so: str, source: str, flags, signatures) -> ctypes.CDLL:
    if not os.path.exists(so):
        _build(so, source, flags)
    lib = ctypes.CDLL(so)
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The host library, built on first use; raises if it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _open(library_path(), SOURCE, CXX_FLAGS, _SIGNATURES)
        return _lib


def load_hnsw() -> ctypes.CDLL:
    """The HNSW library (``csrc/host/hnsw.cpp``, its own ``.so`` built with
    :data:`HNSW_CXX_FLAGS`), built on first use; raises if it cannot be
    built or loaded."""
    global _hnsw_lib
    with _lock:
        if _hnsw_lib is None:
            _hnsw_lib = _open(hnsw_library_path(), HNSW_SOURCE, HNSW_CXX_FLAGS,
                              _HNSW_SIGNATURES)
        return _hnsw_lib


def load_zstd() -> ctypes.CDLL:
    """The zstd library (``csrc/host/zstd.cpp``: the decoder, the raw-block
    encoder and CRC-32C; its own ``.so`` built with
    :data:`CXX_FLAGS`), built on first use; raises if it cannot be built or
    loaded. Nothing falls back to a system libzstd or to Python."""
    global _zstd_lib
    with _lock:
        if _zstd_lib is None:
            _zstd_lib = _open(zstd_library_path(), ZSTD_SOURCE, CXX_FLAGS, _ZSTD_SIGNATURES)
        return _zstd_lib


def native_available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(_F32P)


def _ip(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


# ---------------------------------------------------------------------------
# Block store
# ---------------------------------------------------------------------------
def _block_dtype_code(dtype) -> int:
    """numpy dtype -> header dtype code (0 = f32, 1 = bf16, 2 = int8)."""
    import ml_dtypes

    dtype = np.dtype(dtype)
    if dtype == np.float32:
        return 0
    if dtype == np.dtype(ml_dtypes.bfloat16):
        return 1
    if dtype == np.int8:
        return 2
    raise ValueError(f"native block store supports f32/bf16/int8, not {dtype}")


def _block_dtype_from_code(code: int) -> np.dtype:
    import ml_dtypes

    dtypes = {0: np.float32, 1: ml_dtypes.bfloat16, 2: np.int8}
    if code not in dtypes:
        raise IOError(f"unknown native-block dtype code {code}")
    return np.dtype(dtypes[code])


def _block_operands(emb: np.ndarray, ids: np.ndarray):
    emb = np.ascontiguousarray(emb)
    if emb.dtype == np.float64:
        emb = emb.astype(np.float32)
    code = _block_dtype_code(emb.dtype)
    ids = np.ascontiguousarray(ids, np.int64)
    if emb.ndim != 2 or ids.shape != (emb.shape[0],):
        raise ValueError(f"block rows {emb.shape} and ids {ids.shape} do not match")
    return emb, ids, code


def write_native_block(path: str, emb: np.ndarray, ids: np.ndarray) -> None:
    """Write one ``.cnb`` block; the dtype (f32/bf16/int8) goes in the
    header, float64 is stored as f32."""
    emb, ids, code = _block_operands(emb, ids)
    rows, dim = emb.shape
    rc = load().convdr_write_block_ex(
        path.encode(), emb.ctypes.data, _ip(ids), rows, dim, code
    )
    if rc != 0:
        raise IOError(f"convdr_write_block_ex({path}) failed: rc={rc}")


def write_native_block_plain(path: str, emb: np.ndarray, ids: np.ndarray) -> None:
    """numpy version of :func:`write_native_block`: the same bytes."""
    emb, ids, code = _block_operands(emb, ids)
    with open(path, "wb") as f:
        f.write(np.asarray([_MAGIC, *emb.shape, code], np.uint64).tobytes())
        f.write(emb.tobytes())
        f.write(ids.tobytes())


def read_native_block(path: str, num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(rows [N, D] in the header's dtype, int64 ids [N]) of a ``.cnb``
    file, the rows read by ``num_threads`` threads."""
    lib = load()
    rows, dim, code = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.convdr_read_block_header_ex(
        path.encode(), ctypes.byref(rows), ctypes.byref(dim), ctypes.byref(code)
    )
    if rc != 0:
        raise IOError(f"convdr_read_block_header({path}) failed: rc={rc}")
    emb = np.empty((rows.value, dim.value), _block_dtype_from_code(code.value))
    ids = np.empty(rows.value, np.int64)
    rc = lib.convdr_read_block_ex(
        path.encode(), emb.ctypes.data, _ip(ids), rows.value, dim.value,
        code.value, num_threads,
    )
    if rc != 0:
        raise IOError(f"convdr_read_block({path}) failed: rc={rc}")
    return emb, ids


def _native_header(f, path: str) -> Tuple[int, int, np.dtype]:
    """(rows, dim, dtype) from the header of an open ``.cnb`` file."""
    header = np.frombuffer(f.read(_HEADER_BYTES), np.uint64)
    if header.shape[0] != 4 or header[0] != _MAGIC:
        raise IOError(f"{path} is not a convdr native block")
    return int(header[1]), int(header[2]), _block_dtype_from_code(int(header[3]))


def map_native_block(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(read-only memory map of the rows [N, D], int64 ids [N]) of a
    ``.cnb`` file: a slice of the rows reads only its own bytes."""
    with open(path, "rb") as f:
        rows, dim, dtype = _native_header(f, path)
        f.seek(_HEADER_BYTES + rows * dim * dtype.itemsize)
        id_bytes = f.read(rows * 8)
    if len(id_bytes) != rows * 8:
        raise IOError(f"{path} is truncated")
    if rows == 0:
        return np.zeros((0, dim), dtype), np.zeros(0, np.int64)
    emb = np.memmap(path, dtype, mode="r", offset=_HEADER_BYTES, shape=(rows, dim))
    return emb, np.frombuffer(id_bytes, np.int64).copy()


def read_native_block_plain(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of :func:`read_native_block`."""
    with open(path, "rb") as f:
        rows, dim, dtype = _native_header(f, path)
        payload = f.read(rows * dim * dtype.itemsize)
        id_bytes = f.read(rows * 8)
    if len(payload) != rows * dim * dtype.itemsize or len(id_bytes) != rows * 8:
        raise IOError(f"{path} is truncated")
    emb = np.frombuffer(payload, dtype).reshape(rows, dim)
    return emb.copy(), np.frombuffer(id_bytes, np.int64).copy()


def gather_file_rows(
    path: str,
    payload_off: int,
    dtype,
    dim: int,
    row_idx: np.ndarray,
    *,
    num_threads: int = 4,
) -> np.ndarray:
    """Read only the listed rows of a flat row-major ``[N, dim]`` payload
    that starts at byte ``payload_off`` of ``path``; runs of consecutive
    rows are read with one ``pread``."""
    dtype = np.dtype(dtype)
    row_idx = np.ascontiguousarray(row_idx, np.int64)
    out = np.empty((row_idx.shape[0], dim), dtype)
    if row_idx.shape[0] == 0:
        return out
    rc = load().convdr_gather_rows(
        path.encode(), payload_off, dim * dtype.itemsize, _ip(row_idx),
        row_idx.shape[0], out.ctypes.data, num_threads,
    )
    if rc != 0:
        raise IOError(f"convdr_gather_rows({path}) failed: rc={rc}")
    return out


def gather_file_rows_plain(
    path: str, payload_off: int, dtype, dim: int, row_idx: np.ndarray
) -> np.ndarray:
    """numpy version of :func:`gather_file_rows` (an ``np.memmap`` read)."""
    dtype = np.dtype(dtype)
    row_idx = np.ascontiguousarray(row_idx, np.int64)
    if row_idx.shape[0] == 0:
        return np.empty((0, dim), dtype)
    file_rows = (os.path.getsize(path) - payload_off) // (dim * dtype.itemsize)
    mm = np.memmap(path, dtype=dtype, mode="r", offset=payload_off,
                   shape=(file_rows, dim))
    out = np.array(mm[row_idx])
    del mm
    return out


# ---------------------------------------------------------------------------
# Token-cache split merge
# ---------------------------------------------------------------------------
def merge_token_splits(
    split_paths: List[str], out_path: str, record_bytes: int, max_records: int
) -> np.ndarray:
    """Concatenate worker split files (records of an 8-byte big-endian pid
    then ``record_bytes``) into the cache body at ``out_path``, in split
    order, without the pids; returns the pids in cache order."""
    pids = np.zeros(max_records, np.int64)
    paths = (ctypes.c_char_p * len(split_paths))(*[p.encode() for p in split_paths])
    count = load().convdr_merge_splits(
        paths, len(split_paths), out_path.encode(), record_bytes, _ip(pids),
        max_records,
    )
    if count < 0:
        raise IOError(f"convdr_merge_splits failed: rc={count}")
    return pids[:count]


def merge_token_splits_plain(
    split_paths: List[str], out_path: str, record_bytes: int, max_records: int
) -> np.ndarray:
    """Python version of :func:`merge_token_splits`: the same file, the
    same pids."""
    pids: List[int] = []
    full = 8 + record_bytes
    with open(out_path, "wb") as out:
        for split in split_paths:
            with open(split, "rb") as f:
                while True:
                    rec = f.read(full)
                    if not rec:
                        break
                    if len(rec) != full:
                        raise IOError(f"truncated record in {split}")
                    if len(pids) >= max_records:
                        raise IOError(f"more than {max_records} records in the splits")
                    pids.append(int.from_bytes(rec[:8], "big"))
                    out.write(rec[8:])
    return np.asarray(pids, np.int64)


# ---------------------------------------------------------------------------
# Host-side exact top-k merge
# ---------------------------------------------------------------------------
def _topk_operands(s_a, i_a, s_b, i_b):
    s_a, s_b = (np.ascontiguousarray(x, np.float32) for x in (s_a, s_b))
    i_a, i_b = (np.ascontiguousarray(x, np.int64) for x in (i_a, i_b))
    if not s_a.shape == i_a.shape == s_b.shape == i_b.shape or s_a.ndim != 2:
        raise ValueError("merge_topk_host takes four [Q, k] arrays of one shape")
    return s_a, i_a, s_b, i_b


def merge_topk_host(
    s_a: np.ndarray, i_a: np.ndarray, s_b: np.ndarray, i_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Two-pointer merge of sorted-descending ``[Q, k]`` candidate lists
    into the top k; list A wins ties."""
    s_a, i_a, s_b, i_b = _topk_operands(s_a, i_a, s_b, i_b)
    nq, k = s_a.shape
    out_s, out_i = np.empty_like(s_a), np.empty_like(i_a)
    load().convdr_merge_topk(
        _fp(s_a), _ip(i_a), _fp(s_b), _ip(i_b), nq, k, _fp(out_s), _ip(out_i)
    )
    return out_s, out_i


def merge_topk_host_plain(
    s_a: np.ndarray, i_a: np.ndarray, s_b: np.ndarray, i_b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Python version of :func:`merge_topk_host`."""
    s_a, i_a, s_b, i_b = _topk_operands(s_a, i_a, s_b, i_b)
    nq, k = s_a.shape
    out_s, out_i = np.empty_like(s_a), np.empty_like(i_a)
    for q in range(nq):
        p1 = p2 = 0
        for o in range(k):
            if p2 >= k or (p1 < k and s_a[q, p1] >= s_b[q, p2]):
                out_s[q, o], out_i[q, o] = s_a[q, p1], i_a[q, p1]
                p1 += 1
            else:
                out_s[q, o], out_i[q, o] = s_b[q, p2], i_b[q, p2]
                p2 += 1
    return out_s, out_i


# ---------------------------------------------------------------------------
# zstd and checksums (``csrc/host/zstd.cpp``)
# ---------------------------------------------------------------------------
def _bytes_view(buf) -> np.ndarray:
    """A uint8 view of ``buf`` (bytes, memoryview, mmap slice or array),
    without a copy."""
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    return np.frombuffer(buf, np.uint8)


def _zstd_check(rc: int, what: str) -> int:
    if rc < 0:
        name = load_zstd().zstd_error_name(rc).decode()
        raise ValueError(f"{what}: {name}")
    return rc


def zstd_content_size(frame) -> Optional[int]:
    """The content size a zstd frame declares, None when it declares none;
    raises ``ValueError`` for a malformed header."""
    src = _bytes_view(frame)
    rc = load_zstd().zstd_content_size(src.ctypes.data, src.size)
    return None if rc == -1 else _zstd_check(rc, "zstd header")


def zstd_decompress(frame, out: Optional[np.ndarray] = None,
                    size: Optional[int] = None) -> np.ndarray:
    """Decode the zstd frame(s) in ``frame``. With ``out`` (a writable,
    C-contiguous array) the bytes land there and must fill it exactly.
    Otherwise they go to a new uint8 array, returned at the decoded
    length: of the declared content size, or at most ``size`` bytes.
    Raises ``ValueError`` naming the fault."""
    src = _bytes_view(frame)
    exact = out is not None
    if not exact:
        if size is None:
            size = zstd_content_size(src)
            if size is None:
                raise ValueError("zstd frame declares no content size; pass size")
        out = np.empty(size, np.uint8)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("zstd_decompress needs a writable C-contiguous output")
    dst = out.reshape(-1).view(np.uint8)
    n = _zstd_check(load_zstd().zstd_decompress(src.ctypes.data, src.size, dst.ctypes.data,
                                                dst.size), "zstd frame")
    if not exact:
        return out[:n]
    if n != dst.size:
        raise ValueError(f"zstd frame: decoded {n} bytes into a buffer of {dst.size}")
    return out


def zstd_compress_raw(data) -> bytes:
    """One zstd frame of raw blocks holding ``data`` (with its content
    size): valid zstd that any decoder reads, at no compression."""
    src = _bytes_view(data)
    cap = src.size + 14 + 3 * max(1, -(-src.size // (1 << 17)))
    out = np.empty(cap, np.uint8)
    n = _zstd_check(load_zstd().zstd_compress_raw(src.ctypes.data, src.size, out.ctypes.data,
                                                  cap), "zstd encode")
    return out[:n].tobytes()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), the checksum of OCDBT manifests and nodes."""
    src = _bytes_view(data)
    return int(load_zstd().convdr_crc32c(src.ctypes.data, src.size, crc))
