"""IVF index on the device (FAISS ``IndexIVFFlat`` / ``IndexIVFScalarQuantizer``
/ ``IndexIVFPQ``).

The counterpart of ``convdr_tpu/retrieval/ivf.py``:

  * the coarse quantizer is device k-means (:mod:`convdr_torch.ops.kmeans`);
  * inverted lists are a dense ``[L, cap, D]`` tensor of fixed-capacity
    SUB-LISTS: a cluster of ``l`` rows occupies ``ceil(l / cap)`` sub-lists,
    its centroid duplicated once per sub-list (:func:`_sublist_layout`, the
    JAX package's numpy, byte for byte);
  * search is one function of tensor ops (:func:`_ivf_search_dev`):
    sub-centroid scores, top-``nprobe`` by the exact grouped top-k, a gather
    of the probed sub-lists, one batched product per query, a mask of the
    pad slots and a final top-k over the ``nprobe * cap`` candidates.

Scoring: f32 and bf16 lists in f32 with TF32 off; int8 (SQ8) lists in f32
on the int values, which is exact integer arithmetic (every partial sum of
``D <= 1040`` products of int8 values is below 2^24; a bf16 product would
round its sums above 256); PQ-code lists by ADC (:func:`_adc_candidate_scores`).

Contract (the JAX package's): with ``nprobe == nlist`` every row is scored
and the result set equals the exact flat search; candidates are ranked in
probe-major order and ties go to the earlier candidate position.

An index directory (``centroids.npy``, ``lists.npy``, ``rowids.npy``,
``ivf_meta.json`` and the quantizer's or codec's sidecar) is the JAX
package's format: either package loads the other's.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from convdr_torch.core.config import NOT_PORTED
from convdr_torch.core.device import pick_device
from convdr_torch.ops.exact_search import NEG_INF, grouped_topk_last_axis
from convdr_torch.ops.kmeans import assign_top_t, fit_kmeans
from convdr_torch.ops.pq import PQCodec, pack_codes_4bit, round_lut, unpack_codes_4bit_dev
from convdr_torch.ops.quant import Int8Quantizer, quantize_passages_dev
from convdr_torch.retrieval.blocks import bf16_dtype, iter_embedding_blocks
from convdr_torch.retrieval.refine import cached_refine_store, rank_candidate_tail
from convdr_torch.utils.transfer import device_put_chunked

logger = logging.getLogger(__name__)

_META_FILENAME = "ivf_meta.json"

# the gathered candidates a probe may hold at once (``IVFIndex.search``'s
# default; online serving probes under the same budget)
MAX_CANDIDATE_BYTES = 2 << 30

_STORAGE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "pq4": torch.uint8,
    "pq8": torch.uint8,
}

def _work_itemsize(lists: torch.Tensor) -> int:
    """Bytes a gathered candidate element holds while it is scored: its
    storage item plus, for bf16 and int8 lists, its f32 working copy (the
    PQ-code ADC bounds its own transient by ``_ADC_CHUNK_BYTES``)."""
    converted = lists.dtype not in (torch.float32, torch.uint8)
    return lists.element_size() + (4 if converted else 0)


# per-query byte budget of the ADC gather transient (the JAX package's
# q-chunk bound on its per-query one-hot), and what an element of it holds:
# a gathered f32 LUT entry and its int64 index
_ADC_CHUNK_BYTES = 256 << 20
_ADC_ELEMENT_BYTES = 4 + 8


def _pack_rows(emb: np.ndarray, storage_dtype: str) -> np.ndarray:
    """Rows in the index's host representation (int8 handled by caller)."""
    if storage_dtype == "float32":
        return np.asarray(emb, np.float32)
    if storage_dtype == "bfloat16":
        return np.ascontiguousarray(
            np.asarray(emb).astype(bf16_dtype(), copy=False)
        ).view(np.uint16)
    raise ValueError(f"unknown storage_dtype {storage_dtype!r}")


def _quantize_rows(emb: np.ndarray, scales: np.ndarray, device, rows: int = 1 << 16) -> np.ndarray:
    """SQ8 of host rows on ``device``, ``rows`` at a time: bit-identical to
    :func:`convdr_torch.ops.quant.quantize_passages` (the same f32 divide,
    round half to even and clip)."""
    s = torch.from_numpy(np.asarray(scales, np.float32)).to(device)
    out = np.empty(emb.shape, np.int8)
    for lo in range(0, emb.shape[0], rows):
        chunk = torch.from_numpy(np.asarray(emb[lo : lo + rows], np.float32)).to(device)
        out[lo : lo + rows] = quantize_passages_dev(chunk, s).cpu().numpy()
    return out


def _sublist_layout(
    assign: np.ndarray, nlist: int, cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Chop each natural cluster into fixed-capacity SUB-LISTS.

    ``assign`` [N]: each row's nearest-centroid id. A cluster of ``l`` rows
    occupies ``ceil(l / cap)`` consecutive sub-lists (the last one
    zero-padded), and the cluster's centroid is duplicated once per
    sub-list, so probe selection ranks sub-lists directly and a big cluster
    receives more of the probe budget. Every row stays in its nearest
    cluster.

    Returns (sub_id [N] int32, slot [N] int32, owner [L] int32 natural
    cluster id per sub-list, stats). Memory bound: L * cap <= N + nlist *
    cap rows.
    """
    n = assign.shape[0]
    assign = np.asarray(assign, np.int64)
    sizes = np.bincount(assign, minlength=nlist).astype(np.int64)
    n_sub = -(-sizes // cap)  # ceil; empty clusters get no sub-list
    sub_start = np.concatenate([[0], np.cumsum(n_sub)[:-1]])
    total = int(n_sub.sum())
    order = np.argsort(assign, kind="stable")  # cluster-major, row order kept
    cluster_sorted = assign[order]
    cum_rows = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos_in_cluster = np.arange(n, dtype=np.int64) - cum_rows[cluster_sorted]
    sub_id = np.empty(n, np.int32)
    slot = np.empty(n, np.int32)
    sub_id[order] = (sub_start[cluster_sorted] + pos_in_cluster // cap).astype(np.int32)
    slot[order] = (pos_in_cluster % cap).astype(np.int32)
    owner = np.repeat(np.arange(nlist, dtype=np.int32), n_sub)
    stats = {
        "n_clusters": int(nlist),
        "n_sublists": total,
        "cap": int(cap),
        "pad_rows": int(total * cap - n),
        "pad_frac": float((total * cap - n) / max(total * cap, 1)),
        "max_cluster": int(sizes.max()) if nlist else 0,
        "empty_clusters": int((sizes == 0).sum()),
    }
    return sub_id, slot, owner, stats


def _capacity(n: int, nlist: int, slack: float) -> int:
    """Sub-list capacity: ``slack`` x the mean cluster size, a multiple of 8."""
    cap = int(np.ceil(slack * n / nlist))
    return max(8, -(-cap // 8) * 8)


def _adc_candidate_scores(
    cand_codes: torch.Tensor,
    lut: torch.Tensor,
    ksub: int,
    exact: bool = False,
    packed: bool = False,
) -> torch.Tensor:
    """ADC scores of per-query gathered PQ candidates.

    cand_codes [Q, C, M] integer codes ([Q, C, M/2] packed nibbles with
    ``packed``), lut [Q, M, K] f32 -> scores [Q, C] f32:
    sum_m lut[q, m, cand_codes[q, c, m]]. Candidates differ per query, so
    the LUT entries are gathered per query (a [Q, C, M] transient, where the
    JAX package builds a [Q, C, M, K] one-hot) and summed in f32; queries
    are chunked so the transient stays near 256 MB. The LUT is rounded to
    bf16 unless ``exact``.
    """
    qn, c, width = cand_codes.shape
    m = width * 2 if packed else width
    lut_flat = round_lut(lut, exact).reshape(qn, m * ksub)
    base = torch.arange(m, device=lut.device) * ksub
    q_chunk = max(1, min(qn, _ADC_CHUNK_BYTES // max(c * m * _ADC_ELEMENT_BYTES, 1)))
    out = []
    for lo in range(0, qn, q_chunk):
        codes_c = cand_codes[lo : lo + q_chunk]
        if packed:
            codes_c = unpack_codes_4bit_dev(codes_c)
        idx = codes_c.long()
        idx += base
        idx = idx.reshape(codes_c.shape[0], c * m)
        vals = torch.gather(lut_flat[lo : lo + q_chunk], 1, idx)
        out.append(vals.reshape(-1, c, m).sum(dim=-1))
    return torch.cat(out)


def _ivf_search_dev(
    q_probe: torch.Tensor,
    q_score: torch.Tensor,
    centroids: torch.Tensor,
    lists: torch.Tensor,
    rowids: torch.Tensor,
    k: int,
    nprobe: int,
    exact: bool = False,
    packed: bool = False,
    *,
    max_candidate_bytes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe -> gather -> score -> mask -> top-k, on the lists' device.

    q_probe [Q, D] f32 ranks sub-lists by <q, centroid>; q_score scores
    candidates: [Q, D] f32 rows (float lists), SQ8 int-valued f32 rows (int8
    lists), or [Q, M, K] ADC tables (uint8 PQ-code lists). The probed
    sub-lists are gathered and scored a group at a time, so the gathered
    candidates and their f32 working copy stay under
    ``max_candidate_bytes``, and a query's ADC transient under
    ``_ADC_CHUNK_BYTES`` (one sub-list a group at the least). Returns
    (scores [Q, k] desc f32, global row ids [Q, k] int32, -1 padded).
    """
    qn = q_probe.shape[0]
    nlist, cap, d = lists.shape
    cscores = q_probe @ centroids.T  # [Q, nlist]
    _, probes = grouped_topk_last_axis(cscores, nprobe)  # [Q, P]
    rid = rowids.index_select(0, probes.reshape(-1)).reshape(qn, nprobe * cap)
    group = max_candidate_bytes // (qn * cap * d * _work_itemsize(lists))
    if lists.dtype == torch.uint8:  # and a query's ADC transient within its budget
        group = min(group, _ADC_CHUNK_BYTES // (cap * q_score.shape[1] * _ADC_ELEMENT_BYTES))
    group = max(1, min(nprobe, group))
    parts = []
    for lo in range(0, nprobe, group):
        sub = probes[:, lo : lo + group]
        cand = lists.index_select(0, sub.reshape(-1)).reshape(qn, sub.shape[1] * cap, d)
        if lists.dtype == torch.uint8:
            # IVFPQ: d is the code width M (M/2 packed), q_score the LUT
            parts.append(_adc_candidate_scores(cand, q_score, q_score.shape[-1], exact, packed))
        else:
            # f32 products: exact for int8 and bf16 rows, TF32 off for f32
            parts.append(torch.bmm(cand.float(), q_score.float()[:, :, None])[:, :, 0])
        del cand  # freed before the next group is gathered
    scores = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    scores = scores.masked_fill(rid < 0, NEG_INF)  # pad slots
    kk = min(k, nprobe * cap)
    top_s, sel = grouped_topk_last_axis(scores, kk)
    top_i = torch.gather(rid, 1, sel)
    if kk < k:
        top_s = F.pad(top_s, (0, k - kk), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - kk), value=-1)
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_s, top_i


class IVFIndex:
    """Inverted-file index over fixed-capacity contiguous lists, searched on
    ``device`` (None: the card)."""

    def __init__(
        self,
        centroids: np.ndarray,
        lists: np.ndarray,
        rowids: np.ndarray,
        *,
        storage_dtype: Optional[str] = None,
        quantizer: Optional[Int8Quantizer] = None,
        codec: Optional[PQCodec] = None,
        stats: Optional[dict] = None,
        packed: bool = False,
        device=None,
    ):
        if lists.ndim != 3 or rowids.shape != lists.shape[:2]:
            raise ValueError(
                f"lists [K, cap, D] + rowids [K, cap] expected, got "
                f"{lists.shape} / {rowids.shape}"
            )
        if lists.dtype == np.int8 and quantizer is None:
            raise ValueError("int8 lists need their fitted Int8Quantizer")
        if lists.dtype == np.uint8 and codec is None:
            raise ValueError("PQ-code lists need their fitted PQCodec")
        if storage_dtype is None:
            # bfloat16 lists live as uint16 bit patterns on the host and on
            # disk; uint8 lists are PQ codes
            storage_dtype = {
                np.dtype(np.int8): "int8",
                np.dtype(np.uint16): "bfloat16",
                np.dtype(np.float32): "float32",
            }.get(lists.dtype)
            if storage_dtype is None and lists.dtype == np.uint8:
                storage_dtype = f"pq{codec.nbits}"
            if storage_dtype is None:
                raise ValueError(f"cannot infer storage from {lists.dtype}")
        if storage_dtype not in _STORAGE:
            raise ValueError(f"unknown storage_dtype {storage_dtype!r}")
        self.storage_dtype = storage_dtype
        is_pq = storage_dtype.startswith("pq")
        if packed and (not is_pq or codec is None or codec.nbits != 4):
            raise ValueError("packed lists are pq4 storage only")
        self.packed = bool(packed)
        dim = codec.dim if is_pq else lists.shape[2]
        if centroids.shape != (lists.shape[0], dim):
            raise ValueError(f"centroids must be [nlist, {dim}]")
        width = (codec.m // 2 if packed else codec.m) if is_pq else None
        if is_pq and lists.shape[2] != width:
            raise ValueError(
                f"PQ lists must be [K, cap, {width}] codes "
                f"(packed={packed}), got {lists.shape}"
            )
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self.lists = lists
        self.rowids = np.ascontiguousarray(rowids, np.int32)
        self.quantizer = quantizer
        self.codec = codec
        self.stats = dict(stats or {})
        self._device = device
        self._dev: Optional[tuple] = None

    # -- geometry -------------------------------------------------------
    @property
    def nlist(self) -> int:
        return self.lists.shape[0]

    @property
    def cap(self) -> int:
        return self.lists.shape[1]

    @property
    def dim(self) -> int:
        """Query/embedding dimensionality (PQ lists store M code bytes)."""
        return self.codec.dim if self.codec is not None else self.lists.shape[2]

    @property
    def ntotal(self) -> int:
        return int((self.rowids >= 0).sum())

    @property
    def device(self) -> torch.device:
        return pick_device(self._device)

    # -- build ----------------------------------------------------------
    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        nlist: int,
        *,
        rowids: Optional[np.ndarray] = None,
        storage_dtype: str = "float32",
        slack: float = 1.0,
        iters: int = 20,
        seed: int = 42,
        train_sample: Optional[int] = None,
        centroids: Optional[np.ndarray] = None,
        pq_m: int = 96,
        opq_iters: int = 0,
        pack: bool = False,
        device=None,
    ) -> "IVFIndex":
        """Cluster + pack ``embeddings`` [N, D] into an IVF index.

        ``rowids``: payload id per row (defaults to 0..N-1); what search
        returns. ``slack``: sub-list capacity as a multiple of the mean
        cluster size. ``train_sample``: k-means training subsample cap (None
        = train on everything). ``centroids``: skip training and use these.
        storage_dtype "pq4"/"pq8" stores PQ codes (``pq_m`` bytes a row, the
        IVFPQ composition); ``pack`` stores pq4 nibbles two a byte.
        """
        device = pick_device(device)
        if pack and storage_dtype != "pq4":
            raise ValueError("pack=True is pq4 storage only")
        emb = np.asarray(embeddings)
        n, d = emb.shape
        if rowids is None:
            rowids = np.arange(n, dtype=np.int32)
        rowids = np.asarray(rowids, np.int32)
        if rowids.shape != (n,):
            raise ValueError("rowids must be one id per embedding row")
        if centroids is None:
            centroids = fit_kmeans(
                emb.astype(np.float32, copy=False), nlist, iters=iters, seed=seed,
                sample_max=train_sample, device=device,
            )
        centroids = np.asarray(centroids, np.float32)
        if centroids.shape != (nlist, d):
            raise ValueError(f"centroids [{nlist}, {d}] expected")
        cap = _capacity(n, nlist, slack)
        assign = assign_top_t(emb, centroids, t=1, device=device)[:, 0]
        sub_id, slot, owner, stats = _sublist_layout(assign, nlist, cap)
        logger.info("ivf build: %s", stats)

        quantizer = None
        codec = None
        if storage_dtype == "int8":
            quantizer = Int8Quantizer.fit(np.asarray(emb, np.float32))
            packed_src = _quantize_rows(emb, quantizer.scales, device)
        elif storage_dtype in ("pq4", "pq8"):
            codec = PQCodec.fit(
                np.asarray(emb, np.float32), pq_m, int(storage_dtype[2]), iters=iters,
                seed=seed, sample_max=train_sample, opq_iters=opq_iters, device=device,
            )
            packed_src = codec.encode(np.asarray(emb, np.float32), device=device)
            if pack:
                packed_src = pack_codes_4bit(packed_src)
        else:
            packed_src = _pack_rows(emb, storage_dtype)

        n_sub = stats["n_sublists"]
        flat = np.zeros((n_sub * cap, packed_src.shape[1]), packed_src.dtype)
        flat_ids = np.full(n_sub * cap, -1, np.int32)
        pos = sub_id.astype(np.int64) * cap + slot
        flat[pos] = packed_src
        flat_ids[pos] = rowids
        return cls(
            centroids[owner],  # one (duplicated) centroid per sub-list
            flat.reshape(n_sub, cap, packed_src.shape[1]),
            flat_ids.reshape(n_sub, cap),
            storage_dtype=storage_dtype,
            quantizer=quantizer,
            codec=codec,
            stats=stats,
            packed=pack,
            device=device,
        )

    @classmethod
    def build_from_blocks(
        cls,
        ann_data_dir: str,
        nlist: int,
        *,
        storage_dtype: str = "float32",
        slack: float = 1.0,
        iters: int = 20,
        seed: int = 42,
        train_sample: Optional[int] = None,
        max_blocks: Optional[int] = None,
        pq_m: int = 96,
        opq_iters: int = 0,
        pack: bool = False,
        device=None,
    ) -> "IVFIndex":
        """Build from on-disk embedding blocks (gen_passage_embeddings
        output), RAM-bounded: two streaming passes over the block files hold
        at most one float block + the packed index in memory.

        Pass 1 fits centroids on block 0 (a round-robin shard) and assigns
        every row its nearest cluster; pass 2 re-reads the blocks and packs
        rows into the sub-list tensor. Row payloads are each block's
        emb2offset values. int8 block files reuse their ``int8_scales.npy``
        sidecar (rows are packed as stored; "pq4"/"pq8" encode the
        dequantized rows). For PQ storage the codec trains on an evenly
        strided row sample accumulated across pass-1 blocks.
        """
        device = pick_device(device)
        if storage_dtype not in _STORAGE:
            raise ValueError(f"unknown storage_dtype {storage_dtype!r}")
        if pack and storage_dtype != "pq4":
            raise ValueError("pack=True is pq4 storage only")
        is_pq = storage_dtype.startswith("pq")
        pq_fit_target = (train_sample or 256 * (1 << int(storage_dtype[2]))) if is_pq else 0
        centroids = None
        quantizer = None
        codec = None
        pq_sample: list = []
        pq_sample_rows = 0
        assigns: list = []
        offsets: list = []
        sizes: list = []
        for block_id, emb, emb2offset in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            if emb.shape[0] == 0:
                sizes.append(0)
                continue
            if emb.dtype == np.int8:
                if storage_dtype != "int8" and not is_pq:
                    raise ValueError(
                        "int8 block files can only build an int8 or PQ "
                        "index (the original float rows are gone)"
                    )
                if quantizer is None:
                    quantizer = Int8Quantizer.load(ann_data_dir)
                femb = emb.astype(np.float32) * quantizer.scales[None, :]
            else:
                femb = np.asarray(emb, np.float32)
            if centroids is None:
                centroids = fit_kmeans(
                    femb, nlist, iters=iters, seed=seed, sample_max=train_sample,
                    device=device,
                )
                if storage_dtype == "int8" and quantizer is None:
                    quantizer = Int8Quantizer.fit(femb)
            if is_pq and pq_sample_rows < pq_fit_target:
                stride = max(1, femb.shape[0] // pq_fit_target)
                take = femb[::stride][: pq_fit_target - pq_sample_rows]
                pq_sample.append(np.array(take))
                pq_sample_rows += take.shape[0]
            assigns.append(assign_top_t(femb, centroids, t=1, device=device)[:, 0])
            off = np.asarray(emb2offset, np.int64)
            if off.size and off.max() >= 2**31:
                raise ValueError("emb2offset exceeds int32 payload range")
            offsets.append(off.astype(np.int32))
            sizes.append(emb.shape[0])
            logger.info("ivf pass1 block %d: %d rows assigned", block_id, emb.shape[0])
        if centroids is None:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        if is_pq:
            codec = PQCodec.fit(
                np.concatenate(pq_sample), pq_m, int(storage_dtype[2]), iters=iters,
                seed=seed, sample_max=train_sample, opq_iters=opq_iters, device=device,
            )
            del pq_sample
        assign = np.concatenate(assigns)
        del assigns
        cap = _capacity(assign.shape[0], nlist, slack)
        sub_id, slot, owner, stats = _sublist_layout(assign, nlist, cap)
        del assign
        logger.info("ivf build: %s", stats)

        host_dtype = {
            "float32": np.float32, "bfloat16": np.uint16, "int8": np.int8,
            "pq4": np.uint8, "pq8": np.uint8,
        }[storage_dtype]
        d = (pq_m // 2 if pack else pq_m) if is_pq else centroids.shape[1]
        n_sub = stats["n_sublists"]
        flat = np.zeros((n_sub * cap, d), host_dtype)
        flat_ids = np.full(n_sub * cap, -1, np.int32)
        rowids = np.concatenate(offsets) if offsets else np.zeros(0, np.int32)
        gstart = 0
        bi = 0
        for block_id, emb, _e2o in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            nb = sizes[bi] if bi < len(sizes) else emb.shape[0]
            bi += 1
            if emb.shape[0] == 0:
                continue
            if is_pq:
                if emb.dtype == np.int8:
                    femb = emb.astype(np.float32) * quantizer.scales[None, :]
                else:
                    femb = emb  # raw rows; encode() takes bf16 as it is
                packed = codec.encode(femb, device=device)
                if pack:
                    packed = pack_codes_4bit(packed)
            elif emb.dtype == np.int8:
                packed = emb
            elif storage_dtype == "int8":
                packed = _quantize_rows(emb, quantizer.scales, device)
            else:
                packed = _pack_rows(emb, storage_dtype)
            pos = sub_id[gstart : gstart + nb].astype(np.int64) * cap + slot[gstart : gstart + nb]
            flat[pos] = packed
            flat_ids[pos] = rowids[gstart : gstart + nb]
            gstart += nb
            logger.info("ivf pass2 block %d: %d rows packed", block_id, nb)
        return cls(
            centroids[owner],
            flat.reshape(n_sub, cap, d),
            flat_ids.reshape(n_sub, cap),
            storage_dtype=storage_dtype,
            quantizer=quantizer,
            codec=codec,
            stats=stats,
            packed=pack,
            device=device,
        )

    @classmethod
    def from_pq_index(
        cls,
        pq_index,
        ann_data_dir: str,
        nlist: int,
        *,
        slack: float = 1.0,
        iters: int = 20,
        seed: int = 42,
        train_sample: Optional[int] = None,
        max_blocks: Optional[int] = None,
        centroids: Optional[np.ndarray] = None,
        device=None,
    ) -> "IVFIndex":
        """IVFPQ from an already-encoded flat :class:`PQIndex`: reuse its
        codec and code rows verbatim and add only the coarse structure: one
        streaming pass over the embedding blocks for the k-means fit (block
        0) and the per-row assignment, then a permutation of the existing
        codes into the sub-list slab. ``ann_data_dir`` must hold the same
        corpus in the same block order the PQIndex was built from (row count
        and payload ids are checked). ``centroids`` skips the k-means fit.
        ``device`` None: the PQ index's device.
        """
        device = pick_device(device if device is not None else pq_index._device)
        codec = pq_index.codec
        cent = None if centroids is None else np.asarray(centroids, np.float32)
        quantizer = None
        assigns: list = []
        offsets: list = []
        for block_id, emb, emb2offset in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            if emb.shape[0] == 0:
                continue
            if emb.dtype == np.int8:
                if quantizer is None:
                    quantizer = Int8Quantizer.load(ann_data_dir)
                rows = emb.astype(np.float32) * quantizer.scales[None, :]
            else:
                rows = emb  # assign_top_t uploads f32 / bf16 rows as they are
            if cent is None:
                sample = rows
                if train_sample and rows.shape[0] > train_sample:
                    sel = np.random.Generator(np.random.PCG64(seed)).choice(
                        rows.shape[0], size=train_sample, replace=False
                    )
                    sample = rows[sel]
                if sample.dtype == np.uint16:
                    sample = sample.view(bf16_dtype())
                cent = fit_kmeans(
                    np.asarray(sample, np.float32), nlist, iters=iters, seed=seed,
                    sample_max=train_sample, device=device,
                )
                del sample
            assigns.append(assign_top_t(rows, cent, t=1, device=device)[:, 0])
            offsets.append(np.asarray(emb2offset, np.int64).astype(np.int32))
            logger.info("ivf from_pq pass block %d: %d rows assigned", block_id, emb.shape[0])
        if cent is None:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        if cent.shape != (nlist, codec.dim):
            raise ValueError(f"centroids [{nlist}, {codec.dim}] expected")
        rowids = np.concatenate(offsets) if offsets else np.zeros(0, np.int32)
        if rowids.shape[0] != pq_index.ntotal or not np.array_equal(rowids, pq_index.rowids):
            raise ValueError(
                f"block files in {ann_data_dir} do not match the PQIndex: "
                f"{rowids.shape[0]} rows / payload ids differ from the "
                f"index's {pq_index.ntotal} (the codes were encoded from "
                "a different corpus or block order)"
            )
        assign = np.concatenate(assigns)
        del assigns, offsets
        cap = _capacity(assign.shape[0], nlist, slack)
        sub_id, slot, owner, stats = _sublist_layout(assign, nlist, cap)
        del assign
        logger.info("ivf from_pq build: %s", stats)
        width = pq_index.codes.shape[1]
        n_sub = stats["n_sublists"]
        flat = np.zeros((n_sub * cap, width), np.uint8)
        flat_ids = np.full(n_sub * cap, -1, np.int32)
        pos = sub_id.astype(np.int64) * cap + slot
        flat[pos] = pq_index.codes
        flat_ids[pos] = rowids
        return cls(
            cent[owner],
            flat.reshape(n_sub, cap, width),
            flat_ids.reshape(n_sub, cap),
            storage_dtype=f"pq{codec.nbits}",
            codec=codec,
            stats=stats,
            packed=pq_index.packed,
            device=device,
        )

    # -- capacity ---------------------------------------------------------
    #: Resident-bytes budget per device for the uploaded list tensor (lists +
    #: centroids + rowids): the JAX package's value, overridable per instance.
    max_resident_bytes: int = 12 << 30

    def device_bytes(self) -> int:
        """Device-resident footprint of the uploaded index tensors."""
        return self.lists.nbytes + self.centroids.nbytes + self.rowids.nbytes

    def _check_capacity(self, n_shards: int = 1) -> None:
        per_dev = self.device_bytes() // n_shards
        if per_dev > self.max_resident_bytes:
            shard_hint = (
                ""
                if n_shards > 1
                else " Shard the index over a device mesh "
                "(search(mesh=...) splits sub-lists across devices),"
            )
            raise MemoryError(
                f"IVF index needs {per_dev / 2**30:.1f} GB resident per "
                f"device ({self.nlist} sub-lists x cap {self.cap} x "
                f"{self.lists.shape[2]} {self.storage_dtype}), above the "
                f"{self.max_resident_bytes / 2**30:.1f} GB budget "
                f"(IVFIndex.max_resident_bytes).{shard_hint} use int8 or "
                "pq4 list storage (4x / 32x smaller), or fall back to the "
                "streamed BlockedSearcher, which has no residency "
                "requirement."
            )

    # -- device binding ---------------------------------------------------
    def _device_arrays(self):
        """(centroids, lists, rowids) on the device, uploaded once."""
        if self._dev is None:
            self._check_capacity()
            device = self.device
            flat = self.lists.reshape(self.nlist * self.cap, -1)
            lists_dev = device_put_chunked(
                flat, _STORAGE[self.storage_dtype], device=device
            ).reshape(self.nlist, self.cap, self.lists.shape[2])
            self._dev = (
                torch.from_numpy(self.centroids).to(device),
                lists_dev,
                torch.from_numpy(self.rowids).to(device),
            )
        return self._dev

    # -- search -----------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        nprobe: int = 8,
        max_candidate_bytes: int = MAX_CANDIDATE_BYTES,
        mesh=None,
        exact: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANN top-k. Returns (scores [Q, k] desc f32, rowids [Q, k] int32).

        ``nprobe`` sub-lists are scored per query; queries are chunked, and
        a query's sub-lists grouped, so the gathered candidates and their
        f32 working copy (bf16 and int8 lists) stay under
        ``max_candidate_bytes``. ``exact`` (PQ lists only): an f32 LUT for
        oracle-parity tests. ``mesh`` (a sharded index) is not ported.
        """
        if mesh is not None:
            raise NotImplementedError(f"IVFIndex.search(mesh=...) {NOT_PORTED}")
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}]")
        nprobe = max(1, min(nprobe, self.nlist))
        if self.storage_dtype == "int8":
            q_score, tq = self.quantizer.quantize_queries(q)
        elif self.codec is not None:
            q_score, tq = self.codec.lut(q), None  # [Q, M, K] ADC tables
        else:
            q_score, tq = q, None
        cent, lists_dev, rid_dev = self._device_arrays()
        per_query = nprobe * self.cap * self.lists.shape[2] * _work_itemsize(lists_dev)
        chunk = max(1, int(max_candidate_bytes // per_query))
        device = lists_dev.device
        out_s, out_i = [], []
        for lo in range(0, q.shape[0], chunk):
            hi = min(q.shape[0], lo + chunk)
            s, i = _ivf_search_dev(
                torch.from_numpy(q[lo:hi]).to(device),
                torch.from_numpy(np.ascontiguousarray(q_score[lo:hi])).to(device),
                cent, lists_dev, rid_dev, k, nprobe, exact=exact, packed=self.packed,
                max_candidate_bytes=max_candidate_bytes,
            )
            s, i = s.cpu().numpy(), i.cpu().numpy()
            if tq is not None:
                s = np.where(i >= 0, s * tq[lo:hi], NEG_INF).astype(np.float32)
            out_s.append(s)
            out_i.append(i)
        return np.concatenate(out_s), np.concatenate(out_i)

    def rescore(
        self,
        ann_data_dir: str,
        queries: np.ndarray,
        cand_ids: np.ndarray,
        k: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Refine candidates at O(candidates) disk cost when the block
        directory supports random access (``.cnb`` or protocol-4 pickle
        blocks, :mod:`convdr_torch.retrieval.refine`), else by the one-pass
        streaming :meth:`rescore_block_pass`. Outputs are bit-identical
        either way. The refine store is cached per directory."""
        store = cached_refine_store(self, ann_data_dir, max_blocks)
        if store is not None:
            return store.refine_by_value(queries, cand_ids, k)
        return self.rescore_block_pass(ann_data_dir, queries, cand_ids, k, max_blocks=max_blocks)

    def rescore_block_pass(
        self,
        ann_data_dir: str,
        queries: np.ndarray,
        cand_ids: np.ndarray,
        k: int,
        *,
        max_blocks: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Re-rank IVF candidates against rows streamed from block files
        (FAISS ``IndexRefineFlat`` at one sequential disk pass).

        ``cand_ids`` [Q, C] are ROWIDS (emb2offset payloads, -1 padded, from
        :meth:`search` with ``k = factor * top_n``), matched to block rows by
        value. Duplicate rowids (multi-chunk FirstP) score as the max over
        their rows; int8 block files are dequantized with their scales
        sidecar. Returns (scores [Q, k] f32 desc, rowids [Q, k] int32), ties
        by lower rowid.
        """
        q = np.asarray(queries, np.float32)
        cand = np.asarray(cand_ids, np.int64)
        if q.shape[0] != cand.shape[0]:
            raise ValueError("one candidate row per query expected")
        scores = np.full(cand.shape, NEG_INF, np.float32)
        valid = cand >= 0
        quantizer = None
        saw_block = False
        for _block_id, emb, emb2offset in iter_embedding_blocks(ann_data_dir, max_blocks=max_blocks):
            saw_block = True
            if emb.shape[0] == 0:
                continue
            offs = np.asarray(emb2offset, np.int64)
            order = np.argsort(offs, kind="stable")
            sorted_offs = offs[order]
            left = np.searchsorted(sorted_offs, cand, side="left")
            right = np.searchsorted(sorted_offs, cand, side="right")
            hit = valid & (right > left)
            if not hit.any():
                continue
            if emb.dtype == np.int8 and quantizer is None:
                quantizer = Int8Quantizer.load(ann_data_dir)

            def block_rows(flat_pos):
                rows = emb[order[flat_pos]]
                if rows.dtype == np.int8:
                    return rows.astype(np.float32) * quantizer.scales[None, :]
                return np.asarray(rows, np.float32)

            qi, slot = np.nonzero(hit)
            rows = block_rows(left[qi, slot])  # first row per rowid
            s = np.einsum("cd,cd->c", rows, q[qi], dtype=np.float32)
            np.maximum.at(scores, (qi, slot), s)
            # multi-chunk: extra rows under the same rowid, max-combined with
            # the same per-row einsum (RefineStore relies on it for parity)
            extra = hit & (right - left > 1)
            for eq, es in zip(*np.nonzero(extra)):
                for r in range(left[eq, es] + 1, right[eq, es]):
                    s2 = np.einsum(
                        "cd,cd->c", block_rows(np.array([r])), q[eq][None, :], dtype=np.float32
                    )[0]
                    scores[eq, es] = max(scores[eq, es], s2)
        if not saw_block:
            raise FileNotFoundError(f"No embedding blocks found in {ann_data_dir}")
        missed = int((valid & (scores == NEG_INF)).sum())
        if missed:
            raise ValueError(
                f"{missed} candidate rowids never appeared in "
                f"{ann_data_dir}'s emb2offset payloads — these blocks are "
                "not the ones this index was built from"
            )
        return rank_candidate_tail(scores, cand, k)

    # -- persistence --------------------------------------------------------
    def save(self, index_dir: str) -> None:
        os.makedirs(index_dir, exist_ok=True)
        np.save(os.path.join(index_dir, "centroids.npy"), self.centroids)
        np.save(os.path.join(index_dir, "lists.npy"), self.lists)
        np.save(os.path.join(index_dir, "rowids.npy"), self.rowids)
        if self.quantizer is not None:
            self.quantizer.save(index_dir)
        if self.codec is not None:
            self.codec.save(index_dir)
        meta = {
            "nlist": self.nlist,
            "cap": self.cap,
            "dim": self.dim,
            "ntotal": self.ntotal,
            "storage_dtype": self.storage_dtype,
            "packed": self.packed,
            "stats": self.stats,
        }
        with open(os.path.join(index_dir, _META_FILENAME), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, index_dir: str, *, mmap: bool = True, device=None) -> "IVFIndex":
        with open(os.path.join(index_dir, _META_FILENAME)) as f:
            meta = json.load(f)
        lists = np.load(os.path.join(index_dir, "lists.npy"), mmap_mode="r" if mmap else None)
        return cls(
            np.load(os.path.join(index_dir, "centroids.npy")),
            lists,
            np.load(os.path.join(index_dir, "rowids.npy")),
            storage_dtype=meta["storage_dtype"],
            quantizer=Int8Quantizer.load_optional(index_dir),
            codec=PQCodec.load_optional(index_dir),
            stats=meta.get("stats"),
            packed=meta.get("packed", False),
            device=device,
        )
