"""Device-resident PQ index (FAISS ``IndexPQ`` / ``IndexRefineFlat`` family).

The counterpart of ``convdr_tpu/retrieval/pq_index.py``: the whole corpus
held on the card as PQ codes (48-96 bytes a row), searched by the ADC scan
(:func:`convdr_torch.ops.pq.pq_flat_topk`); optional rescoring re-ranks the
ADC candidates against the original float rows, from an in-memory matrix or
from the embedding block files (:meth:`PQIndex.rescore`). Rowids are
emb2offset payloads, as in the IVF index. An index directory
(``codes.npy``, ``rowids.npy``, ``pq_codebooks.npz``,
``pq_index_meta.json``) is the JAX package's format: either package loads
the other's.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from convdr_torch.core.device import pick_device
from convdr_torch.ops.exact_search import NEG_INF
from convdr_torch.ops.pq import PQCodec, pack_codes_4bit
from convdr_torch.ops.quant import Int8Quantizer, rescore_candidates
from convdr_torch.parallel.mesh import mesh_shard, shard_rows
from convdr_torch.parallel.sharded_search import gather_and_merge, local_pq_topk
from convdr_torch.retrieval.blocks import iter_embedding_blocks
from convdr_torch.retrieval.refine import cached_refine_store, rank_candidate_tail
from convdr_torch.utils.transfer import device_put_chunked

logger = logging.getLogger(__name__)

_META_FILENAME = "pq_index_meta.json"

# [Q, block] f32 score transients bound the query chunk (the ADC one-hot
# block is bounded separately inside pq_flat_topk)
_MAX_QUERY_CHUNK = 2048


class PQIndex:
    """Product-quantized flat index: codes [N, M] uint8 + payload rowids,
    searched on ``device`` (None: the card)."""

    def __init__(
        self,
        codec: PQCodec,
        codes: np.ndarray,
        rowids: Optional[np.ndarray] = None,
        *,
        stats: Optional[dict] = None,
        packed: bool = False,
        device=None,
    ):
        codes = np.asarray(codes)
        if packed and codec.nbits != 4:
            raise ValueError("packed codes are nbits=4 only")
        width = codec.m // 2 if packed else codec.m
        if codes.ndim != 2 or codes.shape[1] != width:
            raise ValueError(
                f"codes must be [N, {width}] for this codec "
                f"(packed={packed}), got {codes.shape}"
            )
        if codes.dtype != np.uint8:
            raise ValueError(f"codes must be uint8, got {codes.dtype}")
        self.packed = bool(packed)
        if rowids is None:
            rowids = np.arange(codes.shape[0], dtype=np.int32)
        rowids = np.asarray(rowids, np.int32)
        if rowids.shape != (codes.shape[0],):
            raise ValueError("rowids must be one id per code row")
        self.codec = codec
        self.codes = codes
        self.rowids = rowids
        self.stats = dict(stats or {})
        self._device = device
        # ((n_shards, shard), codes) of the last upload
        self._dev: Optional[tuple] = None

    # -- geometry -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codec.dim

    @property
    def code_bytes(self) -> int:
        return self.codes.shape[1]

    @property
    def device(self) -> torch.device:
        return pick_device(self._device)

    # -- build ----------------------------------------------------------
    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        m: int,
        nbits: int = 8,
        *,
        rowids: Optional[np.ndarray] = None,
        iters: int = 20,
        seed: int = 42,
        train_sample: Optional[int] = None,
        codec: Optional[PQCodec] = None,
        opq_iters: int = 0,
        pack: bool = False,
        device=None,
    ) -> "PQIndex":
        """Fit a codec on ``embeddings`` [N, D] (or reuse ``codec``) and
        encode every row. ``train_sample`` caps the codebook training set
        (None = ~256 rows per centroid); ``opq_iters`` > 0 also learns the
        OPQ rotation; ``pack`` stores nbits=4 codes two a byte."""
        device = pick_device(device)
        emb = np.asarray(embeddings, np.float32)
        if codec is None:
            codec = PQCodec.fit(
                emb, m, nbits, iters=iters, seed=seed, sample_max=train_sample,
                opq_iters=opq_iters, device=device,
            )
        codes = codec.encode(emb, device=device)
        if pack:
            codes = pack_codes_4bit(codes)
        return cls(
            codec, codes, rowids, stats={"block_sizes": [len(emb)]}, packed=pack,
            device=device,
        )

    @classmethod
    def build_from_blocks(
        cls,
        ann_data_dir: str,
        m: int,
        nbits: int = 8,
        *,
        iters: int = 20,
        seed: int = 42,
        train_sample: Optional[int] = None,
        max_blocks: Optional[int] = None,
        opq_iters: int = 0,
        pack: bool = False,
        device=None,
    ) -> "PQIndex":
        """Build from on-disk embedding blocks in one streaming pass,
        RAM-bounded to max(one float block, the training sample) + the
        codes: float blocks buffer until the training target
        (``train_sample`` or ~256 rows per centroid) is covered or the
        stream ends, the codec fits, pending blocks flush through encode,
        and every later block encodes as it is read. Row payloads are each
        block's emb2offset values; int8 blocks are dequantized with their
        scales sidecar before encoding."""
        device = pick_device(device)
        if pack and nbits != 4:
            raise ValueError("pack=True is nbits=4 only")
        fit_target = train_sample if train_sample else 256 * (1 << nbits)
        codec = None
        quantizer = None
        pending = []  # float blocks seen before the codec could fit
        pending_rows = 0
        all_codes = []
        all_ids = []
        sizes = []

        def fit(rows):
            return PQCodec.fit(
                rows, m, nbits, iters=iters, seed=seed, sample_max=train_sample,
                opq_iters=opq_iters, device=device,
            )

        def flush(femb_list):
            for femb in femb_list:
                codes = codec.encode(femb, device=device)
                all_codes.append(pack_codes_4bit(codes) if pack else codes)

        for block_id, emb, emb2offset in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            if emb.shape[0] == 0:
                sizes.append(0)
                continue
            if emb.dtype == np.int8:
                if quantizer is None:
                    quantizer = Int8Quantizer.load(ann_data_dir)
                femb = emb.astype(np.float32) * quantizer.scales[None, :]
            elif codec is not None:
                femb = emb  # encode() takes bf16 rows as they are
            else:
                femb = np.asarray(emb, np.float32)
            off = np.asarray(emb2offset, np.int64)
            if off.size and off.max() >= 2**31:
                raise ValueError("emb2offset exceeds int32 payload range")
            all_ids.append(off.astype(np.int32))
            sizes.append(emb.shape[0])
            if codec is None:
                pending.append(femb)
                pending_rows += femb.shape[0]
                if pending_rows >= fit_target:
                    codec = fit(np.concatenate(pending) if len(pending) > 1 else pending[0])
                    flush(pending)
                    pending = []
            else:
                flush([femb])
            logger.info("pq build block %d: %d rows read", block_id, emb.shape[0])
        if codec is None and pending:
            # stream ended before the sample target: fit on everything
            codec = fit(np.concatenate(pending) if len(pending) > 1 else pending[0])
            flush(pending)
        if codec is None:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        return cls(
            codec,
            np.concatenate(all_codes),
            np.concatenate(all_ids),
            stats={"block_sizes": sizes},
            packed=pack,
            device=device,
        )

    # -- device binding ---------------------------------------------------
    def _device_codes(self, n_shards: int = 1, shard: int = 0) -> torch.Tensor:
        """``shard``'s contiguous ``ceil(ntotal / n_shards)`` code rows on the
        device (zero rows past the end; the search masks them), uploaded
        once a layout; one shard is every row."""
        key = (n_shards, shard)
        if self._dev is None or self._dev[0] != key:
            self._dev = None  # free the old layout before the upload
            lo, hi, rows = shard_rows(self.ntotal, n_shards, shard)
            self._dev = key, device_put_chunked(
                self.codes[lo:hi], torch.uint8, pad_rows_to=rows, device=self.device
            )
        return self._dev[1]

    # -- search -----------------------------------------------------------
    def adc_topk(
        self, queries: np.ndarray, k: int, *, exact: bool = False, mesh=None,
        index_axis: str = "index",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The ADC scan alone: (scores [Q, k] f32 desc, ROW POSITIONS [Q, k]
        int64, -1 padded), the candidate positions :meth:`rescore` takes.
        Each rank scans its shard of the codes
        (:func:`~convdr_torch.parallel.sharded_search.local_pq_topk`; one
        shard without a mesh); with a ``mesh`` the codes row-shard over
        ``index_axis``, the shards' lists are gathered and merged, and every
        rank returns the same result."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}]")
        n_shards, shard = mesh_shard(mesh, index_axis)
        codes = self._device_codes(n_shards, shard)
        out_s, out_i = [], []
        for lo in range(0, q.shape[0], _MAX_QUERY_CHUNK):
            hi = min(q.shape[0], lo + _MAX_QUERY_CHUNK)
            lut = torch.from_numpy(self.codec.lut(q[lo:hi])).to(codes.device)
            s, i = local_pq_topk(lut, codes, k, self.codec.ksub, shard, n_shards,
                                 valid_rows=self.ntotal, exact=exact, packed=self.packed)
            if mesh is not None:
                s, i = gather_and_merge(mesh, index_axis, s, i, k)
            out_s.append(s.cpu().numpy())
            out_i.append(i.cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_i)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        rescore_factor: int = 0,
        rescore_passages: Optional[np.ndarray] = None,
        mesh=None,
        index_axis: str = "index",
        exact: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ADC top-k. Returns (scores [Q, k] desc f32, rowids [Q, k] int32).

        ``rescore_factor`` > 0 re-ranks the top ``rescore_factor * k`` ADC
        candidates against ``rescore_passages`` [N, D] float rows (indexed
        by ROW POSITION; pass the matrix the index was built from); use
        :meth:`rescore` when the float rows exist only as block files.
        With a ``mesh``, codes row-shard over ``index_axis`` (:meth:`adc_topk`).
        """
        if rescore_factor and rescore_passages is None:
            raise ValueError(
                "rescore_factor needs rescore_passages (in-memory float "
                "rows) — or call rescore_block_pass for block files"
            )
        k_cand = max(k, rescore_factor * k) if rescore_factor else k
        s, pos = self.adc_topk(queries, k_cand, exact=exact, mesh=mesh, index_axis=index_axis)
        if rescore_factor:
            s, pos = rescore_candidates(
                np.asarray(queries, np.float32), rescore_passages, pos, k
            )
        ids = np.where(pos >= 0, self.rowids[np.clip(pos, 0, None)], -1)
        return s.astype(np.float32), ids.astype(np.int32)

    def rescore(
        self,
        ann_data_dir: str,
        queries: np.ndarray,
        cand_pos: np.ndarray,
        k: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine ADC candidates (ROW POSITIONS) at O(candidates) disk cost
        when the block directory supports random access (``.cnb`` or
        protocol-4 pickle blocks), else by the one-pass streaming
        :meth:`rescore_block_pass`; bit-identical outputs either way."""
        sizes = self.stats.get("block_sizes")
        if not sizes:
            raise ValueError(
                "rescore needs stats['block_sizes'] (an index from build_from_blocks)"
            )
        store = cached_refine_store(self, ann_data_dir, max_blocks)
        if store is not None:
            out_s, out_p = store.refine_positional(queries, cand_pos, k, block_sizes=sizes)
            ids = np.where(
                out_p >= 0, self.rowids[np.clip(out_p.astype(np.int64), 0, None)], -1
            )
            return out_s, ids.astype(np.int32)
        return self.rescore_block_pass(ann_data_dir, queries, cand_pos, k, max_blocks=max_blocks)

    def rescore_block_pass(
        self,
        ann_data_dir: str,
        queries: np.ndarray,
        cand_pos: np.ndarray,
        k: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Re-rank ADC candidates against float rows streamed from block
        files (one sequential disk pass, no corpus residency).

        ``cand_pos`` [Q, m] are ROW POSITIONS (block-concatenation order,
        recorded in ``stats['block_sizes']``) from :meth:`adc_topk`. Returns
        (scores [Q, k] f32 desc, rowids [Q, k] int32) with exact float
        ranking of the candidate set.
        """
        sizes = self.stats.get("block_sizes")
        if not sizes:
            raise ValueError(
                "rescore_block_pass needs stats['block_sizes'] (an index "
                "from build_from_blocks)"
            )
        starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        q = np.asarray(queries, np.float32)
        pos = np.asarray(cand_pos, np.int64)
        scores = np.full(pos.shape, NEG_INF, np.float32)
        bi = 0
        quantizer = None
        for _block_id, emb, _e2o in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            lo, hi_ = starts[bi], starts[bi + 1]
            bi += 1
            if emb.shape[0] == 0:
                continue
            in_block = (pos >= lo) & (pos < hi_)
            if not in_block.any():
                continue
            qi, slot = np.nonzero(in_block)
            rows = emb[pos[qi, slot] - lo]  # [C, D]
            if rows.dtype == np.int8:
                if quantizer is None:
                    quantizer = Int8Quantizer.load(ann_data_dir)
                rows = rows.astype(np.float32) * quantizer.scales[None, :]
            else:
                rows = np.asarray(rows, np.float32)
            scores[qi, slot] = np.einsum("cd,cd->c", rows, q[qi], dtype=np.float32)
        if bi < len(sizes):
            raise ValueError(
                f"block files in {ann_data_dir} ended at block {bi} but the "
                f"index was built from {len(sizes)} blocks"
            )
        out_s, out_p = rank_candidate_tail(scores, pos, k)
        ids = np.where(out_p >= 0, self.rowids[np.clip(out_p.astype(np.int64), 0, None)], -1)
        return out_s, ids.astype(np.int32)

    # -- persistence --------------------------------------------------------
    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        np.save(os.path.join(index_dir, "codes.npy"), self.codes)
        np.save(os.path.join(index_dir, "rowids.npy"), self.rowids)
        self.codec.save(index_dir)
        meta = {
            "ntotal": self.ntotal,
            "dim": self.dim,
            "m": self.codec.m,
            "nbits": self.codec.nbits,
            "packed": self.packed,
            "stats": self.stats,
        }
        with open(os.path.join(index_dir, _META_FILENAME), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, index_dir: str, *, mmap: bool = True, device=None) -> "PQIndex":
        meta_path = os.path.join(index_dir, _META_FILENAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no PQ index at {meta_path}")
        with open(meta_path) as f:
            meta = json.load(f)
        return cls(
            PQCodec.load(index_dir),
            np.load(os.path.join(index_dir, "codes.npy"), mmap_mode="r" if mmap else None),
            np.load(os.path.join(index_dir, "rowids.npy")),
            stats=meta.get("stats"),
            packed=meta.get("packed", False),
            device=device,
        )


def is_pq_index_dir(index_dir: str) -> bool:
    return os.path.exists(os.path.join(index_dir, _META_FILENAME))
