"""Corpus embedding pipeline: token cache -> embedding blocks.

The counterpart of ``convdr_tpu/retrieval/embed_corpus.py``: one program
streams the memmapped token cache in fixed-shape batches through the
encoder's ``body_emb`` on one device and writes reference-format blocks,
the retrieval shards :class:`~convdr_torch.retrieval.searcher.
BlockedSearcher` consumes. Block ``b`` holds records ``i % num_blocks == b``
(the reference's per-rank round-robin split).

Multi-chunk models return ``[B, C, E]``; chunk rows are flattened into extra
block rows sharing the same token-cache offset
(gen_passage_embeddings.py:117-123), deduped later at run-writing time.

``storage_dtype="int8"`` writes SQ8 blocks (:mod:`convdr_torch.ops.quant`):
the scales are fitted on the first non-empty block and saved beside the
blocks as ``int8_scales.npy``, and every block is quantized with them.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from convdr_torch.core.config import NOT_PORTED
from convdr_torch.data.token_cache import TokenCache
from convdr_torch.ops.quant import Int8Quantizer
from convdr_torch.retrieval.blocks import write_embedding_block

logger = logging.getLogger(__name__)


def default_length_buckets(max_seq_length: int) -> tuple:
    """Sequence-length buckets for :func:`generate_embeddings`: 64 (short
    passages), then 128-step rungs, capped by the cache record length."""
    rungs = [b for b in (64, 128, 256, 384) if b < max_seq_length]
    return tuple(rungs) + (max_seq_length,)


class _BucketBuffer:
    """Accumulates rows per length bucket; flushes fixed-shape batches.

    Each bucket flushes at a constant token budget (``batch_size`` rows at
    the top rung): shorter rungs take proportionally more rows per batch,
    which keeps activation memory flat and cuts launch count. The flush
    order is the JAX package's, so both write blocks in the same row order.
    """

    def __init__(self, buckets, batch_size: int):
        self.buckets = tuple(sorted(buckets))
        top = self.buckets[-1]
        self.batch_sizes = {b: batch_size * (top // b) for b in self.buckets}
        self._rows = {b: [] for b in self.buckets}  # (ids, lens, offsets)

    def add(self, ids: np.ndarray, lens: np.ndarray, offsets: np.ndarray):
        """Route rows to buckets; return full (bucket, ids, lens, offsets)
        batches. Eager (a list, not a generator): buffer state must not
        depend on how far a caller iterates."""
        bidx = np.searchsorted(np.asarray(self.buckets), lens, side="left")
        # rows longer than the top rung land in it (truncation = the cache
        # writer's own clamp semantics)
        bidx = np.minimum(bidx, len(self.buckets) - 1)
        out = []
        for j, bucket in enumerate(self.buckets):
            sel = bidx == j
            if not sel.any():
                continue
            self._rows[bucket].append((ids[sel, :bucket], lens[sel], offsets[sel]))
            out.extend(self._drain(bucket, full_only=True))
        return out

    def flush(self):
        """Return the remaining partial batches, padded to batch_size."""
        out = []
        for bucket in self.buckets:
            out.extend(self._drain(bucket, full_only=False))
        return out

    def _drain(self, bucket: int, *, full_only: bool):
        batch_size = self.batch_sizes[bucket]
        rows = self._rows[bucket]
        n = sum(r[0].shape[0] for r in rows)
        if n == 0 or (full_only and n < batch_size):
            return []
        ids = np.concatenate([r[0] for r in rows], axis=0)
        lens = np.concatenate([r[1] for r in rows], axis=0)
        offsets = np.concatenate([r[2] for r in rows], axis=0)
        out = []
        pos = 0
        while n - pos >= batch_size:
            sl = slice(pos, pos + batch_size)
            out.append((bucket, ids[sl], lens[sl], offsets[sl]))
            pos += batch_size
        rest = n - pos
        if full_only:
            self._rows[bucket] = (
                [(ids[pos:], lens[pos:], offsets[pos:])] if rest else []
            )
            return out
        self._rows[bucket] = []
        if rest:
            pad = batch_size - rest
            out.append((
                bucket,
                np.concatenate([ids[pos:], np.repeat(ids[-1:], pad, 0)], 0),
                np.concatenate([lens[pos:], np.repeat(lens[-1:], pad, 0)], 0),
                np.concatenate([offsets[pos:], np.full(pad, -1, offsets.dtype)], 0),
            ))
        return out


def generate_embeddings(
    apply_fn: Callable,
    cache: TokenCache,
    out_dir: str,
    *,
    device: torch.device,
    batch_size: int = 64,
    num_blocks: int = 1,
    length_buckets: Optional[tuple] = None,
    storage_dtype: str = "float32",
) -> int:
    """Encode the whole cache into ``num_blocks`` reference-format blocks.

    ``apply_fn(ids, mask, is_query)`` (the passage side) is :func:`convdr_torch.core.loading.
    make_apply_fn`'s encoder. Returns the total number of embedding rows
    written (chunks included).

    ``length_buckets`` (ascending, last >= the cache record length) batches
    records by length rung so short passages aren't encoded at full padded
    length -- embeddings are unchanged (pads never influence valid tokens)
    -- and row order within a block follows flush order, not cache order;
    consumers map rows through the block's offset array. For multi-chunk
    models pass chunk-multiple rungs (each record encodes only the chunks
    its rung covers; empty chunks are skipped instead of indexed).

    ``storage_dtype``: "float32" (the reference's blocks) or "int8" (SQ8,
    a quarter of the disk and device memory, with the scales sidecar).
    "bfloat16" blocks are not ported yet and raise.
    """
    if storage_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown storage_dtype {storage_dtype!r}")
    if storage_dtype == "bfloat16":
        raise NotImplementedError(f"bfloat16 embedding blocks {NOT_PORTED}")
    quantizer = None  # int8: fitted on the first non-empty block
    if length_buckets is not None:
        length_buckets = tuple(sorted(length_buckets))
        if length_buckets[-1] < cache.max_seq_length:
            raise ValueError(
                f"top length bucket {length_buckets[-1]} is shorter than the "
                f"cache record length {cache.max_seq_length}; rows would be "
                "truncated"
            )

    def encode(ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
        ids_t = torch.from_numpy(np.ascontiguousarray(ids)).to(device)
        lens_t = torch.from_numpy(np.ascontiguousarray(lens)).to(device)
        positions = torch.arange(ids_t.shape[1], device=device)
        mask = (positions[None, :] < lens_t[:, None]).to(torch.int32)
        return apply_fn(ids_t, mask, False).cpu().numpy()

    total_rows = 0
    emb_dim = 0  # learned from the first encoded batch; used for empty shards
    for block_id in range(num_blocks):
        embs_out = []
        ids_out = []

        def run_batch(ids, lens, offsets):
            out = encode(ids, lens)
            valid = offsets >= 0
            # multi-chunk [B, C, E] -> C rows per record. Under length
            # buckets only chunks covering real tokens are emitted.
            if out.ndim == 3:
                chunk_len = ids.shape[1] // out.shape[1]
                for chunk in range(out.shape[1]):
                    keep = valid
                    if length_buckets is not None:
                        keep = valid & (lens > chunk * chunk_len)
                    embs_out.append(out[keep, chunk, :])
                    ids_out.append(offsets[keep])
            else:
                embs_out.append(out[valid])
                ids_out.append(offsets[valid])

        batches = cache.iter_batches(
            batch_size, shard_index=block_id, num_shards=num_blocks
        )
        if length_buckets is None:
            for ids, lens, offsets in batches:
                run_batch(ids, lens, offsets)
        else:
            buf = _BucketBuffer(length_buckets, batch_size)
            for ids, lens, offsets in batches:
                valid = offsets >= 0
                for _b, bids, blens, boffs in buf.add(
                    ids[valid], lens[valid], offsets[valid]
                ):
                    run_batch(bids, blens, boffs)
            for _b, bids, blens, boffs in buf.flush():
                run_batch(bids, blens, boffs)
        if embs_out:
            block_embs = np.concatenate(embs_out, axis=0).astype(np.float32, copy=False)
            emb_dim = block_embs.shape[-1]
            if storage_dtype == "int8":
                # fit on the first non-empty block (an unbiased i % num_blocks
                # shard, the sample FAISS trains its quantizer on), save the
                # sidecar the searcher folds into queries, clip later blocks'
                # rare out-of-range values
                if quantizer is None:
                    quantizer = Int8Quantizer.fit(block_embs)
                    quantizer.save(out_dir)
                block_embs = quantizer.quantize_passages(block_embs)
        else:
            # empty round-robin shard (num_blocks > record count): keep the
            # real embedding dim so downstream loads/search stay well-typed
            empty = np.int8 if storage_dtype == "int8" else np.float32
            block_embs = np.zeros((0, emb_dim), empty)
        block_ids = (
            np.concatenate(ids_out, axis=0) if ids_out else np.zeros((0,), np.int64)
        )
        write_embedding_block(out_dir, block_id, block_embs, block_ids)
        total_rows += block_embs.shape[0]
        logger.info(
            "wrote block %d: %d rows -> %s", block_id, block_embs.shape[0], out_dir
        )
    return total_rows
