"""zarr v2 arrays over an OCDBT store: the array layer of orbax checkpoints.

The JAX package's orbax checkpoints keep each array as a zarr v2 array
(https://zarr-specs.readthedocs.io/en/latest/v2/v2.0.html) under two kinds
of OCDBT key: ``<name>/.zarray``, the JSON metadata, and one key per chunk,
``<name>/<i>.<j>...`` (dimension separator ``.``; a scalar's one chunk is
``<name>/0``). tensorstore writes C-order chunks, compressed with zstd and
no filters; a chunk at the array's edge is stored whole and cut to the
shape when read.

:func:`read_array` decodes every chunk straight into its slice of one
preallocated tensor (into the tensor itself when one chunk covers the
array), so an array is never held twice. ``bfloat16`` is read as 16-bit
words and viewed as ``torch.bfloat16``. :func:`array_items` is the writer's
side: the metadata and one chunk for the whole array, as a zstd frame of
raw blocks.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from convdr_torch import native_io

# zarr dtype -> (numpy dtype the bytes are read as, torch dtype of the result)
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f2": (np.float16, torch.float16),
    "<f8": (np.float64, torch.float64),
    "<i4": (np.int32, torch.int32),
    "<i8": (np.int64, torch.int64),
    "<u4": (np.uint32, torch.uint32),
    "|b1": (np.bool_, torch.bool),
    "bfloat16": (np.int16, torch.bfloat16),
}
_ZARR_OF = {torch_dtype: name for name, (_, torch_dtype) in DTYPES.items()}
# the compressor tensorstore writes by default (orbax keeps it)
ZSTD_COMPRESSOR = {"id": "zstd", "level": 1}


@dataclass
class ZArray:
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: str
    fill_value: Any
    compressor: Optional[dict]
    separator: str

    @property
    def grid(self) -> Tuple[int, ...]:
        return tuple(math.ceil(s / c) if s else 0 for s, c in zip(self.shape, self.chunks))

    def chunk_key(self, name: str, index: Tuple[int, ...]) -> str:
        return f"{name}/" + (self.separator.join(str(i) for i in index) if index else "0")


def parse_zarray(raw, name: str = "") -> ZArray:
    """Parse and check one ``.zarray``; raises ``ValueError`` for anything
    the reader does not handle (another order, filters, compressor or
    dtype)."""
    meta = json.loads(bytes(raw))
    where = f"zarr array {name!r}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')} is not 2")
    if meta.get("order") != "C":
        raise ValueError(f"{where}: order {meta.get('order')!r} is not supported (C only)")
    if meta.get("filters") is not None:
        raise ValueError(f"{where}: filters {meta['filters']} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r} is not supported (zstd only)")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not supported")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {list(chunks)} do not fit shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{where}: dimension separator {sep!r}")
    return ZArray(shape, chunks, meta["dtype"], meta.get("fill_value"), comp, sep)


def _fill(arr: np.ndarray, fill_value) -> None:
    if fill_value is None:
        arr.fill(0)
    elif isinstance(fill_value, str):  # "NaN", "Infinity", "-Infinity"
        arr.fill(float(fill_value.replace("Infinity", "inf")))
    else:
        arr.fill(fill_value)


def _decode(za: ZArray, value, out: np.ndarray) -> None:
    """One stored chunk into ``out`` (exactly its size in bytes)."""
    if za.compressor is None:
        src = np.frombuffer(value, np.uint8)
        if src.size != out.nbytes:
            raise ValueError(f"raw zarr chunk holds {src.size} bytes, expected {out.nbytes}")
        out.reshape(-1).view(np.uint8)[:] = src
    else:
        native_io.zstd_decompress(value, out=out)


def read_array(reader, name: str) -> torch.Tensor:
    """The zarr array ``name`` of an OCDBT store (an
    :class:`~convdr_torch.utils.ocdbt.OcdbtReader`) as a CPU tensor."""
    za = parse_zarray(reader.read(f"{name}/.zarray"), name)
    np_dtype, torch_dtype = DTYPES[za.dtype]
    fill = za.fill_value
    if za.dtype == "bfloat16" and fill is not None:  # the fill's bits, as int16
        fill = int(torch.tensor(float(fill.replace("Infinity", "inf"))
                                if isinstance(fill, str) else fill,
                                dtype=torch.bfloat16).view(torch.int16))
    out = np.empty(za.shape, np_dtype)
    whole = za.chunks == za.shape
    for index in np.ndindex(*za.grid):  # a scalar: one chunk, index ()
        key = za.chunk_key(name, index)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, za.chunks, za.shape))
        if key not in reader:
            _fill(out[region], fill)
            continue
        if whole:
            _decode(za, reader.read(key), out)
            continue
        chunk = np.empty(za.chunks, np_dtype)
        _decode(za, reader.read(key), chunk)
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return torch.from_numpy(out).view(torch_dtype)


def array_items(name: str, tensor: torch.Tensor) -> List[Tuple[str, Any]]:
    """The OCDBT items of ``tensor`` as a zarr v2 array ``name``: its
    ``.zarray`` (one chunk over the whole array, zstd, as tensorstore
    writes) and the chunk, a function that encodes it when called."""
    if tensor.dtype not in _ZARR_OF:
        raise ValueError(f"zarr writer: dtype {tensor.dtype} is not supported")
    shape = list(tensor.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": ZSTD_COMPRESSOR,
            "dimension_separator": ".", "dtype": _ZARR_OF[tensor.dtype], "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    items: List[Tuple[str, Any]] = [
        (f"{name}/.zarray", json.dumps(meta, separators=(",", ":")).encode())]
    if 0 in shape:
        return items
    za = parse_zarray(items[0][1], name)
    t = tensor.detach().to("cpu").contiguous()

    def chunk() -> bytes:
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return native_io.zstd_compress_raw(words.numpy())

    items.append((za.chunk_key(name, (0,) * len(shape)), chunk))
    return items
