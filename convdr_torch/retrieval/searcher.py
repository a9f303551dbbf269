"""Blocked exact search: stream embedding blocks through the device.

The counterpart of ``convdr_tpu/retrieval/searcher.py`` (reference
``search_one_by_one``, run_convdr_inference.py:157-242): load block b (on a
background thread, one block ahead), upload it through pinned host memory,
search it with :func:`~convdr_torch.ops.exact_search.flat_ip_topk`, map
local rows to token-cache offsets via the block's id array (:190-191), and
merge with the running top-N preferring earlier blocks on ties (:217-229).

Blocks are zero-padded to the score kernel's row tile
(:data:`~convdr_torch.ops.fused_search.ROW_TILE`) on the device; the
padded rows are masked. (The JAX package pads to a 1.25x ladder of sizes to
bound XLA compiles; eager PyTorch compiles nothing, so the ladder would only
add padded work.) bf16 storage is a device-side cast on upload; scores
still accumulate in f32.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from convdr_torch.core.config import NOT_PORTED, SearchConfig
from convdr_torch.ops.exact_search import NEG_INF, flat_ip_topk, merge_topk
from convdr_torch.ops.fused_search import ROW_TILE
from convdr_torch.retrieval.blocks import iter_embedding_blocks

logger = logging.getLogger(__name__)

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Host staging chunk for uploads: two pinned buffers of this size alternate.
UPLOAD_CHUNK_BYTES = 256 << 20


def prefetch_iter(iterable, depth: int = 1):
    """Run an iterator on a background thread, ``depth`` items ahead.

    Overlaps the next block's disk read + unpickle with the current block's
    upload + device search. Read-only producer, bounded queue, exceptions
    re-raised at the consumer.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    done = object()
    closed = threading.Event()  # consumer gone: producer must not block on put

    def put_checked(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put_checked(item):
                    return
            put_checked(done)
        except BaseException as e:  # propagate into the consumer
            put_checked(("__prefetch_error__", e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        # Abandoned early: unblock the producer so it exits instead of
        # holding blocks alive for the life of the process.
        closed.set()


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
    src = torch.from_numpy(np.ascontiguousarray(rows))
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


class BlockedSearcher:
    """Exact top-N retrieval over on-disk embedding blocks, on one device."""

    def __init__(self, config: SearchConfig = SearchConfig(), *, device: torch.device):
        if config.storage_dtype not in _STORAGE:
            raise NotImplementedError(
                f"storage_dtype {config.storage_dtype!r} {NOT_PORTED}"
            )
        self.config = config
        self.device = device

    def _queries(self, query_embs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(query_embs, np.float32)).to(self.device)

    def search_block(
        self, query_embs: np.ndarray, block_embs: np.ndarray, top_n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-N of one block; returns (scores, local row indices)."""
        s, i = self._search_block_device(self._queries(query_embs), block_embs, top_n)
        return s.cpu().numpy(), i.cpu().numpy()

    def _search_block_device(
        self, q: torch.Tensor, block_embs: np.ndarray, top_n: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-N of one host block as device tensors.

        Blocks above ``config.max_device_block_bytes`` are searched as
        sequential sub-blocks merged in order: sub-block row indices are
        shifted by their offset and :func:`merge_topk` prefers its first
        argument on ties, so the result is bit-identical to a single-shot
        search (lower row index wins ties either way).
        """
        if block_embs.dtype != np.float32:
            raise NotImplementedError(
                f"searching {block_embs.dtype} blocks {NOT_PORTED}; the port "
                "reads float32 blocks (bf16 storage is a cast on upload)"
            )
        n = block_embs.shape[0]
        storage = _STORAGE[self.config.storage_dtype]
        row_bytes = block_embs.shape[1] * storage.itemsize
        cap_rows = max(1024, int(self.config.max_device_block_bytes // row_bytes))
        # round the cap to the scan-block quantum so sub-blocks split evenly
        quantum = min(self.config.passage_block_size, cap_rows)
        cap_rows = max(quantum, cap_rows // quantum * quantum)
        if n > cap_rows:
            merged_s = merged_i = None
            for lo in range(0, n, cap_rows):
                s, i = self._search_block_device(q, block_embs[lo : lo + cap_rows], top_n)
                i = torch.where(i >= 0, i + lo, i)
                if merged_s is None:
                    merged_s, merged_i = s, i
                else:
                    merged_s, merged_i = merge_topk(merged_s, merged_i, s, i, top_n)
            return merged_s, merged_i
        padded_n = -(-n // ROW_TILE) * ROW_TILE
        p = upload_rows(block_embs, padded_n, storage, self.device)
        return flat_ip_topk(
            q,
            p,
            top_n,
            block_rows=min(self.config.passage_block_size, padded_n),
            valid_rows=n,
        )

    def search_blocks(
        self,
        ann_data_dir: str,
        query_embs: np.ndarray,
        top_n: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Search all blocks under ``ann_data_dir``; returns
        (scores [Q, top_n] desc, token-cache offsets [Q, top_n], -1 padded)."""
        q = self._queries(query_embs)
        merged_s: Optional[torch.Tensor] = None
        merged_i: Optional[torch.Tensor] = None
        t_start = time.time()
        for block_id, emb, emb2offset in prefetch_iter(
            iter_embedding_blocks(ann_data_dir)
        ):
            if emb.shape[0] == 0:
                logger.info("block %d is empty; skipping", block_id)
                continue
            logger.info("searching block %d: %s passages", block_id, emb.shape[0])
            s, i = self._search_block_device(q, emb, top_n)
            # local row -> token-cache offset on device; -1 rows stay -1
            offs = torch.from_numpy(emb2offset.astype(np.int64)).to(self.device)
            o_j = torch.where(i >= 0, offs[i.clamp(min=0)], i)
            if merged_s is None:
                merged_s, merged_i = s, o_j
            else:
                merged_s, merged_i = merge_topk(merged_s, merged_i, s, o_j, top_n)
        if merged_s is None:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        out_s = merged_s.cpu().numpy()
        out_i = merged_i.cpu().numpy()
        elapsed = time.time() - t_start
        logger.info(
            "search: total=%.4fs queries=%d per_query=%.6fs",
            elapsed, q.shape[0], elapsed / max(q.shape[0], 1),
        )
        out_i = np.where(out_s <= NEG_INF, -1, out_i)
        return out_s, out_i

    def search_arrays(
        self,
        query_embs: np.ndarray,
        passage_embs: np.ndarray,
        emb2offset: np.ndarray,
        top_n: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """In-memory single-block convenience path."""
        s, i = self.search_block(query_embs, passage_embs, top_n)
        offsets = np.where(i >= 0, emb2offset[np.clip(i, 0, None)], -1)
        return s, offsets
