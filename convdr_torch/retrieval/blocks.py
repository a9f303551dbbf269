"""Embedding block storage: the retrieval shards on disk.

Byte-compatible with the reference's block files (utils/util.py:108-111
writes ``{prefix}_data_obj_{rank}.pb`` pickles; gen_passage_embeddings.py:
156-167 uses prefixes ``passage__emb_p_`` / ``passage__embid_p_``;
run_convdr_inference.py:163-175 reads blocks 0.. until one is missing), and
with the JAX package's blocks in both formats. A pickle block is a pair:

  * ``passage__emb_p__data_obj_{b}.pb``   -- pickled rows [N_b, E]
  * ``passage__embid_p__data_obj_{b}.pb`` -- pickled int64  [N_b] token-cache
    offsets (NOT pids; offset -> pid goes through offset2pid at eval time)

A native block is one ``passage_block_{b}.cnb`` file of the C++ block store
(:mod:`convdr_torch.native_io`): header, rows, int64 offsets.

Rows are float32 (the reference's format), bfloat16 (an
``ml_dtypes.bfloat16`` ndarray, as the JAX package writes it; half the disk
and device memory) or int8 (SQ8 storage, ``ops/quant.py``, paired with the
``int8_scales.npy`` sidecar in the same directory). :func:`host_tensor`
turns host rows of any of these dtypes into a CPU tensor without a copy.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

EMB_PREFIX = "passage__emb_p_"
EMBID_PREFIX = "passage__embid_p_"
NATIVE_TEMPLATE = "passage_block_{block_id}.cnb"


def bf16_dtype() -> np.dtype:
    """numpy's bfloat16 (``ml_dtypes``, which bf16 pickles need to load)."""
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def host_tensor(rows: np.ndarray) -> torch.Tensor:
    """A CPU tensor over host rows (f32, int8 or ``ml_dtypes`` bf16, which
    ``torch.from_numpy`` does not take: its bits go through uint16)."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == bf16_dtype():
        return torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(rows)


def _block_path(data_dir: str, prefix: str, block_id: int) -> str:
    return os.path.join(data_dir, f"{prefix}_data_obj_{block_id}.pb")


def _native_path(data_dir: str, block_id: int) -> str:
    return os.path.join(data_dir, NATIVE_TEMPLATE.format(block_id=block_id))


def write_embedding_block(
    data_dir: str,
    block_id: int,
    embeddings: np.ndarray,
    offsets: np.ndarray,
    *,
    emb_prefix: str = EMB_PREFIX,
    embid_prefix: str = EMBID_PREFIX,
    fmt: str = "pickle",
) -> None:
    """Write one block: ``fmt="pickle"`` the reference's pickle pair,
    ``fmt="native"`` one ``.cnb`` file through the C++ block store. f32,
    bf16 and int8 rows keep their dtype in both formats; float64 is
    stored as f32."""
    if fmt not in ("pickle", "native"):
        raise ValueError(f"unknown block format {fmt!r}")
    os.makedirs(data_dir, exist_ok=True)
    emb = np.asarray(embeddings)
    if emb.dtype == np.float64:
        emb = emb.astype(np.float32)
    if emb.dtype not in (np.float32, np.int8, bf16_dtype()):
        raise ValueError(f"blocks hold float32, bfloat16 or int8 rows, not {emb.dtype}")
    if fmt == "native":
        from convdr_torch.native_io import write_native_block

        write_native_block(
            _native_path(data_dir, block_id), emb, np.asarray(offsets, np.int64)
        )
        return
    with open(_block_path(data_dir, emb_prefix, block_id), "wb") as f:
        pickle.dump(emb, f, protocol=4)
    with open(_block_path(data_dir, embid_prefix, block_id), "wb") as f:
        pickle.dump(np.asarray(offsets), f, protocol=4)


def load_embedding_block(
    data_dir: str,
    block_id: int,
    *,
    emb_prefix: str = EMB_PREFIX,
    embid_prefix: str = EMBID_PREFIX,
    mmap: bool = False,
    dim: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(rows, offsets) of block ``block_id``: its ``.cnb`` file if there is
    one, else its pickle pair; None if neither exists. ``mmap`` returns the
    rows as a read-only memory map, so a caller that needs a row range
    reads only that range: a ``.cnb`` file's, or a protocol-4 pickle's
    payload, whose dtype the row width ``dim`` settles
    (:func:`~convdr_torch.retrieval.refine.locate_pickle_payload`, as the
    refine store maps it). A pickle with no such payload is read whole."""
    native = _native_path(data_dir, block_id)
    if os.path.exists(native):
        from convdr_torch.native_io import map_native_block, read_native_block

        return map_native_block(native) if mmap else read_native_block(native)
    emb_path = _block_path(data_dir, emb_prefix, block_id)
    id_path = _block_path(data_dir, embid_prefix, block_id)
    if not (os.path.exists(emb_path) and os.path.exists(id_path)):
        return None
    with open(id_path, "rb") as f:
        ids = np.asarray(pickle.load(f))
    if mmap and ids.shape[0]:
        from convdr_torch.retrieval.refine import locate_pickle_payload

        if dim is None:
            raise ValueError("a memory map of a pickle block needs its row width (dim)")
        try:
            offset, dtype = locate_pickle_payload(emb_path, ids.shape[0], dim)
        except ValueError:
            pass  # another pickle layout: read it whole below
        else:
            return np.memmap(emb_path, dtype, mode="r", offset=offset,
                             shape=(ids.shape[0], dim)), ids
    with open(emb_path, "rb") as f:
        emb = pickle.load(f)
    return np.asarray(emb), ids


def iter_embedding_blocks(
    data_dir: str,
    *,
    max_blocks: Optional[int] = None,
    emb_prefix: str = EMB_PREFIX,
    embid_prefix: str = EMBID_PREFIX,
    mmap: bool = False,
    dim: Optional[int] = None,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield consecutive blocks starting at 0; stop at the first gap
    (reference semantics, run_convdr_inference.py:176-177). ``mmap`` and
    ``dim`` as in :func:`load_embedding_block`."""
    b = 0
    while max_blocks is None or b < max_blocks:
        blk = load_embedding_block(
            data_dir, b, emb_prefix=emb_prefix, embid_prefix=embid_prefix, mmap=mmap,
            dim=dim,
        )
        if blk is None:
            break
        yield b, blk[0], blk[1]
        b += 1
