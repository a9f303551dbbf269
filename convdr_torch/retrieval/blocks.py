"""Embedding block storage: the retrieval shards on disk.

Byte-compatible with the reference's block files (utils/util.py:108-111
writes ``{prefix}_data_obj_{rank}.pb`` pickles; gen_passage_embeddings.py:
156-167 uses prefixes ``passage__emb_p_`` / ``passage__embid_p_``;
run_convdr_inference.py:163-175 reads blocks 0.. until one is missing), and
so with the JAX package's pickle blocks. A block is a pair:

  * ``passage__emb_p__data_obj_{b}.pb``   -- pickled float32 [N_b, E]
  * ``passage__embid_p__data_obj_{b}.pb`` -- pickled int64  [N_b] token-cache
    offsets (NOT pids; offset -> pid goes through offset2pid at eval time)

Blocks hold float32 rows, or int8 rows (SQ8 storage, ``ops/quant.py``)
paired with the ``int8_scales.npy`` sidecar in the same directory; both are
plain numpy pickles, as the JAX package writes them. On-disk bf16 blocks
and the native ``.cnb`` block store are not ported yet (ROADMAP.md): a bf16
pickle needs ``ml_dtypes``, a package the port does not depend on.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np

EMB_PREFIX = "passage__emb_p_"
EMBID_PREFIX = "passage__embid_p_"
NATIVE_TEMPLATE = "passage_block_{block_id}.cnb"


def _block_path(data_dir: str, prefix: str, block_id: int) -> str:
    return os.path.join(data_dir, f"{prefix}_data_obj_{block_id}.pb")


def write_embedding_block(
    data_dir: str,
    block_id: int,
    embeddings: np.ndarray,
    offsets: np.ndarray,
) -> None:
    """Write one reference-format block (f32 or int8 embeddings; float64 is
    downcast to f32)."""
    os.makedirs(data_dir, exist_ok=True)
    emb = np.asarray(embeddings)
    if emb.dtype == np.float64:
        emb = emb.astype(np.float32)
    if emb.dtype not in (np.float32, np.int8):
        raise NotImplementedError(
            f"writing {emb.dtype} blocks is not yet ported to convdr_torch, "
            "see ROADMAP.md; write float32 or int8"
        )
    with open(_block_path(data_dir, EMB_PREFIX, block_id), "wb") as f:
        pickle.dump(emb, f, protocol=4)
    with open(_block_path(data_dir, EMBID_PREFIX, block_id), "wb") as f:
        pickle.dump(np.asarray(offsets), f, protocol=4)


def load_embedding_block(
    data_dir: str, block_id: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if os.path.exists(os.path.join(data_dir, NATIVE_TEMPLATE.format(block_id=block_id))):
        raise NotImplementedError(
            f"native .cnb blocks in {data_dir} are not yet ported to "
            "convdr_torch, see ROADMAP.md; write pickle blocks"
        )
    emb_path = _block_path(data_dir, EMB_PREFIX, block_id)
    id_path = _block_path(data_dir, EMBID_PREFIX, block_id)
    if not (os.path.exists(emb_path) and os.path.exists(id_path)):
        return None
    with open(emb_path, "rb") as f:
        emb = pickle.load(f)
    with open(id_path, "rb") as f:
        ids = pickle.load(f)
    return np.asarray(emb), np.asarray(ids)


def iter_embedding_blocks(
    data_dir: str,
    *,
    max_blocks: Optional[int] = None,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield consecutive blocks starting at 0; stop at the first gap
    (reference semantics, run_convdr_inference.py:176-177)."""
    b = 0
    while max_blocks is None or b < max_blocks:
        blk = load_embedding_block(data_dir, b)
        if blk is None:
            break
        yield b, blk[0], blk[1]
        b += 1
