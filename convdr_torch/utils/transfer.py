"""Chunked host -> device uploads.

The counterpart of ``convdr_tpu/utils/transfer.py``. :func:`upload_rows`
copies host rows to the card through two alternating pinned staging buffers
of ``UPLOAD_CHUNK_BYTES`` into one device tensor, casts on the device and
zeroes padding rows there; the block searcher uploads every block with it.
:func:`device_put_chunked` is the JAX package's entry on top of it, for the
index builders and indexes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from convdr_torch.retrieval.blocks import bf16_dtype, host_tensor

# Host staging chunk for uploads: two pinned buffers of this size alternate.
UPLOAD_CHUNK_BYTES = 256 << 20


def upload_rows(
    rows: np.ndarray, padded_n: int, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """[N, D] host rows -> [padded_n, D] ``dtype`` tensor on ``device``,
    rows past N zero.

    On a card the copy goes through two alternating pinned staging buffers
    (a pageable copy would be staged by CUDA anyway, one small piece
    at a time); a dtype change is a cast on the device after the copy.
    """
    n, d = rows.shape
    src = host_tensor(rows)
    out = torch.empty((padded_n, d), dtype=dtype, device=device)
    out[n:].zero_()
    if device.type != "cuda":
        out[:n].copy_(src)
        return out
    chunk = max(1, UPLOAD_CHUNK_BYTES // max(1, d * src.element_size()))
    staging = [
        torch.empty((min(chunk, n), d), dtype=src.dtype, pin_memory=True)
        for _ in range(2 if n > chunk else 1)
    ]
    cast_buf = (
        torch.empty((min(chunk, n), d), dtype=src.dtype, device=device)
        if dtype != src.dtype else None
    )
    copied = [None] * len(staging)
    for j, lo in enumerate(range(0, n, chunk)):
        hi = min(n, lo + chunk)
        slot = j % len(staging)
        if copied[slot] is not None:
            copied[slot].synchronize()  # its previous copy has left the buffer
        buf = staging[slot][: hi - lo]
        buf.copy_(src[lo:hi])
        if cast_buf is None:
            out[lo:hi].copy_(buf, non_blocking=True)
        else:
            cast_buf[: hi - lo].copy_(buf, non_blocking=True)
            out[lo:hi].copy_(cast_buf[: hi - lo])
        copied[slot] = torch.cuda.Event()
        copied[slot].record()
    for ev in copied:
        if ev is not None:
            ev.synchronize()
    return out


def device_put_chunked(
    arr: np.ndarray, dtype=None, *, pad_rows_to: int = 0, device: torch.device
) -> torch.Tensor:
    """Upload ``arr`` ([N, ...]) as one ``dtype`` tensor on ``device`` with
    ``max(N, pad_rows_to)`` rows, the rows past N zero. ``uint16`` arrays are
    bf16 bit patterns (the block-file and index layout) and upload as bf16;
    ``dtype`` defaults to the host dtype."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(bf16_dtype())
    if dtype is None:
        dtype = torch.bfloat16 if arr.dtype == bf16_dtype() else torch.from_numpy(
            np.empty(0, arr.dtype)).dtype
    n = arr.shape[0]
    rows = arr.reshape(n, int(np.prod(arr.shape[1:])))
    with warnings.catch_warnings():
        # a read-only array (a memory-mapped index file) is only read here
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        out = upload_rows(rows, max(n, pad_rows_to), dtype, torch.device(device))
    return out.reshape(out.shape[0], *arr.shape[1:])
