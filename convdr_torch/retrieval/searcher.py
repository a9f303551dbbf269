"""Blocked exact search: stream embedding blocks through the device.

The counterpart of ``convdr_tpu/retrieval/searcher.py`` (reference
``search_one_by_one``, run_convdr_inference.py:157-242): load block b (on a
background thread, one block ahead), upload it through pinned host memory
(:func:`convdr_torch.utils.transfer.upload_rows`), search it with
:func:`~convdr_torch.ops.exact_search.flat_ip_topk`, map local rows to
token-cache offsets via the block's id array (:190-191), and merge with
the running top-N preferring earlier blocks on ties (:217-229).

Blocks are zero-padded to the score kernel's row tile
(:data:`~convdr_torch.ops.fused_search.ROW_TILE`) on the device; the
padded rows are masked. (The JAX package pads to a 1.25x ladder of sizes to
bound XLA compiles; eager PyTorch compiles nothing, so the ladder would only
add padded work.) Block files hold f32, bf16 or int8 rows, as pickles or
``.cnb`` files (:mod:`~convdr_torch.retrieval.blocks`). Rows are uploaded in
their file dtype, so bf16 files move half the host -> device bytes of f32
ones; any other dtype the search needs is a cast on the device (bf16
storage of f32 files; f32 storage of bf16 files, exact). Scores accumulate
in f32 either way.

int8 storage (SQ8, :mod:`convdr_torch.ops.quant`): int8 blocks upload as
they are, float blocks are quantized on the device
(:func:`~convdr_torch.ops.quant.quantize_passages_dev`, bit-identical to the
host quantizer); the queries carry the per-dimension scales, the scan runs
on exact integer scores, and each query's scale ``tq`` rescales the merged
result once. ``rescore_factor`` (int8 or bf16 storage, float block files)
re-ranks each block's top ``rescore_factor * top_n`` with full-precision
host scores before the merge (FAISS ``IndexRefineFlat``); it needs float32
block files, the original rows.

With a ``mesh`` each block's rows shard over ``index_axis``: a rank moves
only its contiguous row range to its device (``.cnb`` and protocol-4
pickle blocks are read through a memory map, so it reads only that
range), searches it as the single-device search does its whole block
(:func:`~convdr_torch.parallel.sharded_search.local_flat_ip_topk`, one
shard without a mesh), and gathers and merges the shards' lists; every
rank merges the same block results in the same order, so every rank
returns the same (scores, offsets), equal to the single-device search's.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.core.device import pick_device
from convdr_torch.ops.exact_search import NEG_INF, merge_topk
from convdr_torch.ops.fused_search import ROW_TILE
from convdr_torch.ops.quant import (
    Int8Quantizer,
    quantize_passages_dev,
    rescore_candidates,
)
from convdr_torch.parallel.mesh import check_mesh, mesh_shard, shard_rows
from convdr_torch.parallel.sharded_search import gather_and_merge, local_flat_ip_topk
from convdr_torch.retrieval.blocks import (
    bf16_dtype,
    iter_embedding_blocks,
    load_embedding_block,
)
from convdr_torch.utils.transfer import upload_rows

logger = logging.getLogger(__name__)

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


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


class BlockedSearcher:
    """Exact top-N retrieval over on-disk embedding blocks.

    ``device`` None means the card (raising without one, as
    :func:`~convdr_torch.core.device.pick_device`); under a ``mesh`` it is
    this rank's device, and block rows shard over ``index_axis``.
    """

    def __init__(
        self,
        config: SearchConfig = SearchConfig(),
        *,
        device=None,
        mesh=None,
        index_axis: str = "index",
        quantizer: Optional[Int8Quantizer] = None,
    ):
        if config.storage_dtype not in _STORAGE:
            raise ValueError(f"unknown storage_dtype {config.storage_dtype!r}")
        self.config = config
        self.device = pick_device(device)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.index_axis = index_axis
        # int8 storage needs the fitted per-dimension scales to fold into
        # queries; pass one here, or search_blocks loads the sidecar from
        # the block directory, or search_arrays fits on the passed corpus.
        self.quantizer = quantizer

    # -- int8 (SQ8) plumbing -------------------------------------------
    @property
    def _int8(self) -> bool:
        return self.config.storage_dtype == "int8"

    @property
    def _rescoring(self) -> bool:
        return self.config.rescore_factor > 0 and self.config.storage_dtype in (
            "int8", "bfloat16"
        )

    def _require_quantizer(self) -> Int8Quantizer:
        if self.quantizer is None:
            raise ValueError(
                "storage_dtype='int8' needs fitted scales: pass "
                "quantizer=Int8Quantizer(...) or search a block dir with "
                "an int8_scales.npy sidecar (generate_embeddings writes it)"
            )
        return self.quantizer

    def _prepare_queries(self, query_embs: np.ndarray):
        """-> (device queries, per-query score scale [Q, 1] or None).

        int8 storage folds the passage scales into the queries and
        quantizes them; the int-valued f32 rows drive an integer-exact scan
        whose scores are rescaled by ``tq`` only at the end (a positive
        per-query scale: the ranking is unaffected).
        """
        tq = None
        if self._int8:
            query_embs, tq = self._require_quantizer().quantize_queries(query_embs)
        q = torch.from_numpy(np.asarray(query_embs, np.float32)).to(self.device)
        return q, tq

    @staticmethod
    def _scale_scores(s: np.ndarray, i: np.ndarray, tq) -> np.ndarray:
        if tq is None:
            return s
        return np.where(i >= 0, s * tq, NEG_INF).astype(np.float32)

    def search_block(
        self, query_embs: np.ndarray, block_embs: np.ndarray, top_n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-N of one block; returns (scores, local row indices)."""
        q, tq = self._prepare_queries(query_embs)
        s, i = self._search_block_device(q, block_embs, top_n)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        return self._scale_scores(s, i, tq), i

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
        if block_embs.dtype not in (np.float32, np.int8, bf16_dtype()):
            raise ValueError(
                f"blocks hold float32, bfloat16 or int8 rows, not {block_embs.dtype}"
            )
        if block_embs.dtype == np.int8 and not self._int8:
            raise ValueError(
                "int8 blocks need storage_dtype='int8' (and their scales sidecar)"
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
        # this shard's contiguous rows (all of them without a mesh), padded
        # to the shards' common height; a memory map is read here, only
        # those rows
        n_shards, shard = mesh_shard(self.mesh, self.index_axis)
        lo, hi, rows = shard_rows(n, n_shards, shard, ROW_TILE)
        part = block_embs[lo:hi]
        if isinstance(part, np.memmap):
            part = np.array(part)
        s, i = local_flat_ip_topk(
            q, self._upload(part, rows, storage), top_n, shard, n_shards,
            valid_rows=n, block_rows=min(self.config.passage_block_size, rows),
            precision=self.config.matmul_precision,
        )
        if self.mesh is not None:
            s, i = gather_and_merge(self.mesh, self.index_axis, s, i, top_n)
        return s, i

    def _upload(self, rows: np.ndarray, padded_n: int, storage: torch.dtype) -> torch.Tensor:
        if self._int8 and rows.dtype != np.int8:
            # float rows under an int8 config: upload in source precision
            # (a plain int8 cast would truncate, not quantize), quantize on
            # the device, free the float copy
            scales = torch.from_numpy(self._require_quantizer().scales).to(self.device)
            p_float = upload_rows(rows, padded_n, torch.float32, self.device)
            p = quantize_passages_dev(p_float, scales)
            del p_float
            return p
        return upload_rows(rows, padded_n, storage, self.device)

    def _search_rescored(
        self, q: torch.Tensor, q_orig: np.ndarray, block_embs: np.ndarray, top_n: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The block's top ``rescore_factor * top_n`` quantized candidates,
        re-ranked on the host with full-precision scores."""
        if block_embs.dtype != np.float32:
            raise ValueError(
                "rescore_factor needs float block files (the original rows "
                f"are the refinement source); these blocks are already {block_embs.dtype}"
            )
        m = self.config.rescore_factor * top_n
        _s, i_m = self._search_block_device(q, block_embs, m)
        return rescore_candidates(q_orig, block_embs, i_m.cpu().numpy(), top_n)

    def _ensure_quantizer(self, ann_data_dir: str) -> None:
        """int8 storage: the sidecar of the block dir, else (float blocks
        only) scales fitted on block 0, an unbiased round-robin shard."""
        if not self._int8 or self.quantizer is not None:
            return
        self.quantizer = Int8Quantizer.load_optional(ann_data_dir)
        if self.quantizer is not None:
            return
        blk = load_embedding_block(ann_data_dir, 0)
        if blk is None:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        if blk[0].dtype == np.int8:
            raise FileNotFoundError(
                f"int8 blocks in {ann_data_dir} have no int8_scales.npy "
                "sidecar; regenerate with generate_embeddings(storage_dtype='int8')"
            )
        logger.warning("no int8_scales.npy in %s; fitting scales on block 0", ann_data_dir)
        self.quantizer = Int8Quantizer.fit(blk[0])

    def search_blocks(
        self,
        ann_data_dir: str,
        query_embs: np.ndarray,
        top_n: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Search all blocks under ``ann_data_dir``; returns
        (scores [Q, top_n] desc, token-cache offsets [Q, top_n], -1 padded).

        ``max_blocks`` limits the scan to the first blocks (e.g. a one-block
        warm-up before a timed full sweep).

        int8 storage: the scales come from the dir's ``int8_scales.npy``
        (unless a quantizer was passed); float blocks without one self-fit
        on block 0 with a warning, int8 blocks without one raise. With
        ``config.rescore_factor`` > 0 (int8 or bf16 storage) the blocks
        must be float files; each block's quantized top ``rescore_factor *
        top_n`` is re-ranked on the host before the cross-block merge.
        """
        self._ensure_quantizer(ann_data_dir)
        q, tq = self._prepare_queries(query_embs)
        rescoring = self._rescoring
        q_orig = np.asarray(query_embs, np.float32) if rescoring else None
        merged_s: Optional[torch.Tensor] = None
        merged_i: Optional[torch.Tensor] = None
        t_start = time.time()
        for block_id, emb, emb2offset in prefetch_iter(
            iter_embedding_blocks(
                ann_data_dir, max_blocks=max_blocks, mmap=self.mesh is not None,
                dim=q.shape[1],
            )
        ):
            if emb.shape[0] == 0:
                logger.info("block %d is empty; skipping", block_id)
                continue
            logger.info("searching block %d: %s passages", block_id, emb.shape[0])
            if rescoring:
                s, i = self._search_rescored(q, q_orig, emb, top_n)
                s, i = (torch.from_numpy(x).to(self.device) for x in (s, i.astype(np.int64)))
            else:
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
        if not rescoring:
            out_s = self._scale_scores(out_s, out_i, tq)
        return out_s, out_i

    def search_arrays(
        self,
        query_embs: np.ndarray,
        passage_embs: np.ndarray,
        emb2offset: np.ndarray,
        top_n: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """In-memory single-block convenience path.

        int8 storage: the scales fit on the passed corpus when no quantizer
        is set (float input); ``config.rescore_factor`` > 0 (int8 or bf16
        storage) re-ranks the quantized top ``factor * top_n`` with
        full-precision host scores.
        """
        if self._int8 and self.quantizer is None:
            if passage_embs.dtype == np.int8:
                self._require_quantizer()  # raises with guidance
            self.quantizer = Int8Quantizer.fit(passage_embs)
        if self._rescoring:
            if passage_embs.dtype != np.float32:
                raise ValueError(
                    "rescore_factor needs the original float rows; the "
                    f"passed corpus is already {passage_embs.dtype}"
                )
            q, _tq = self._prepare_queries(query_embs)
            s, i = self._search_rescored(
                q, np.asarray(query_embs, np.float32), passage_embs, top_n
            )
        else:
            s, i = self.search_block(query_embs, passage_embs, top_n)
        offsets = np.where(i >= 0, emb2offset[np.clip(i, 0, None)], -1)
        return s, offsets
