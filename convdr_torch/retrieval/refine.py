"""Candidate-proportional refinement: random-access row gather + rescoring.

The counterpart of ``convdr_tpu/retrieval/refine.py`` (FAISS
``IndexRefineFlat``, whose refine vectors stay resident for random access):
re-ranking k' candidates reads O(k') rows from the block files instead of
streaming every block once per query batch (the ``rescore_block_pass``
methods of the IVF and PQ indexes):

  * ``.cnb`` blocks are flat ``header + rows + ids``: rows are read with
    coalesced ``pread`` calls (:func:`convdr_torch.native_io.gather_file_rows`);
  * reference-format pickled blocks (protocol-4 numpy pickles) hold their
    C-order payload as one BINBYTES/BINBYTES8 run: :func:`locate_pickle_payload`
    finds its byte offset, after which the file is read like a raw block.

A :class:`RefineStore` opens a block directory once (ids and payload
offsets, per-block sorted offset maps), then serves
:meth:`~RefineStore.refine_by_value` (the IVF contract: candidates are
emb2offset ROWID VALUES; duplicates max-combine) and
:meth:`~RefineStore.refine_positional` (the PQ contract: candidates are
block-concatenation ROW POSITIONS), bit-identical to the streaming passes:
the same per-row f32 einsum, and max-combining is order-independent.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from convdr_torch.native_io import _HEADER_BYTES, gather_file_rows, map_native_block
from convdr_torch.ops.exact_search import NEG_INF
from convdr_torch.ops.quant import Int8Quantizer
from convdr_torch.retrieval.blocks import (
    EMB_PREFIX,
    EMBID_PREFIX,
    _block_path,
    _native_path,
    bf16_dtype,
)

_ITEMSIZE_DTYPES: Tuple[Tuple[int, str], ...] = (
    (4, "float32"),
    (2, "bfloat16"),
    (1, "int8"),
)


def _np_dtype(name: str) -> np.dtype:
    return bf16_dtype() if name == "bfloat16" else np.dtype(name)


def locate_pickle_payload(path: str, rows: int, dim: int) -> Tuple[int, np.dtype]:
    """Find the byte offset + dtype of a pickled numpy block's raw payload.

    ``pickle.dump(arr, protocol=4)`` serializes ``arr.tobytes()`` (C order)
    as one BINBYTES (op ``B`` + u32 length), BINBYTES8 (op ``0x8e`` + u64
    length) or, under 256 bytes, SHORT_BINBYTES opcode, followed only by a
    few closing opcodes. The element dtype is the one whose byte length
    ``rows * dim * itemsize`` matches an opcode prefix sitting ``nbytes``
    before that small tail (f32/bf16/int8 lengths differ, so at most one
    matches).

    Raises ``ValueError`` when no payload is found (not a protocol-4 numpy
    pickle of the expected geometry; callers then stream the blocks).
    """
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        for itemsize, dtype_name in _ITEMSIZE_DTYPES:
            nbytes = rows * dim * itemsize
            win_hi = file_size - nbytes  # latest possible payload start
            if win_hi < 9:
                continue
            win_lo = max(0, win_hi - 96)
            f.seek(win_lo)
            window = f.read(win_hi - win_lo + 9)
            prefixes = [b"\x8e" + struct.pack("<Q", nbytes)]  # BINBYTES8
            if nbytes <= 0xFFFFFFFF:
                # a u32 prefix cannot express a >4 GiB payload
                prefixes.append(b"B" + struct.pack("<I", nbytes))
            if nbytes < 256:
                prefixes.append(b"C" + bytes([nbytes]))  # SHORT_BINBYTES
            for prefix in prefixes:
                pos = window.rfind(prefix)
                while pos != -1:
                    off = win_lo + pos + len(prefix)
                    if off + nbytes <= file_size:
                        return off, _np_dtype(dtype_name)
                    pos = window.rfind(prefix, 0, pos)
    raise ValueError(
        f"{path}: no contiguous numpy payload found for rows={rows} "
        f"dim={dim} (f32/bf16/int8) — not a protocol-4 pickle block"
    )


@dataclass
class _BlockHandle:
    path: str
    payload_off: int
    dtype: np.dtype
    rows: int
    start: int  # global row position of this block's row 0
    offs: np.ndarray  # emb2offset payload [rows] int64
    sorted_offs: np.ndarray  # offs[order]
    order: np.ndarray  # stable argsort(offs): ties in original row order


def rank_candidate_tail(
    scores: np.ndarray, ids: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Shared candidate-ranking tail of every rescore path: canonicalise
    candidate order (id asc, -1 padding last), then take the top ``k`` by
    (score desc, id asc), padding short rows with (-inf, -1)."""
    ids = np.asarray(ids, np.int64)
    valid = ids >= 0
    key = np.where(valid, ids, np.iinfo(np.int64).max)
    ord0 = np.argsort(key, axis=1, kind="stable")
    ids = np.take_along_axis(ids, ord0, axis=1)
    scores = np.take_along_axis(scores, ord0, axis=1)
    kk = min(k, ids.shape[1])
    sel = np.argsort(-scores, axis=1, kind="stable")[:, :kk]
    out_s = np.take_along_axis(scores, sel, axis=1)
    out_i = np.take_along_axis(ids, sel, axis=1)
    if kk < k:
        out_s = np.pad(out_s, ((0, 0), (0, k - kk)), constant_values=NEG_INF)
        out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    out_i = np.where(out_s <= NEG_INF, -1, out_i)
    return out_s.astype(np.float32), out_i.astype(np.int32)


def cached_refine_store(index, data_dir: str, max_blocks):
    """Open-or-reuse a :class:`RefineStore` for ``data_dir``, cached on
    ``index`` (the IVF and PQ indexes' ``rescore`` call it per batch).
    Returns ``None`` when the directory has no random-access format; callers
    then stream the blocks. Only that format miss (``ValueError``) is
    cached, since a directory's format does not change between calls; an
    ``OSError`` (a missing sidecar or block, a read that failed) is retried
    on the next call."""
    key = (os.path.abspath(data_dir), max_blocks)
    cache = getattr(index, "_refine_stores", None)
    if cache is None:
        cache = index._refine_stores = {}
    if key in cache:
        return cache[key]
    log = logging.getLogger(index.__class__.__module__)
    try:
        store = RefineStore.open(data_dir, index.dim, max_blocks=max_blocks)
    except ValueError as e:
        log.warning(
            "no random-access refine for %s (%s); falling back to the "
            "streaming block pass", data_dir, e,
        )
        store = None
    except OSError as e:
        log.warning(
            "no random-access refine for %s this call (%s); falling back to "
            "the streaming block pass", data_dir, e,
        )
        return None
    cache[key] = store
    return store


class RefineStore:
    """Random-access view over an embedding-block directory.

    Opens every block's id array and payload offset once (ids are ~8 bytes
    a row, never the rows), then serves candidate-row gathers at
    O(candidates) disk cost.
    """

    def __init__(
        self,
        blocks: List[_BlockHandle],
        quantizer: Optional[Int8Quantizer],
        data_dir: str,
    ):
        if not blocks:
            raise FileNotFoundError(f"No embedding blocks in {data_dir}")
        self.blocks = blocks
        self.quantizer = quantizer
        self.data_dir = data_dir
        self.ntotal = sum(b.rows for b in blocks)
        self.dim: Optional[int] = None  # set by open()

    @classmethod
    def open(
        cls,
        data_dir: str,
        dim: int,
        *,
        max_blocks: Optional[int] = None,
        emb_prefix: str = EMB_PREFIX,
        embid_prefix: str = EMBID_PREFIX,
    ) -> "RefineStore":
        """Scan blocks 0.. until the first gap. ``dim`` disambiguates the
        pickle payload dtype."""
        blocks: List[_BlockHandle] = []
        start = 0
        b = 0
        need_quant = False
        while max_blocks is None or b < max_blocks:
            native = _native_path(data_dir, b)
            emb_path = _block_path(data_dir, emb_prefix, b)
            id_path = _block_path(data_dir, embid_prefix, b)
            if os.path.exists(native):
                emb, offs = map_native_block(native)
                (rows, ndim), dtype = emb.shape, emb.dtype
                del emb  # the header and ids are all this store keeps
                if ndim != dim:
                    raise ValueError(f"{native}: dim {ndim} != expected {dim}")
                path, payload_off = native, _HEADER_BYTES
            elif os.path.exists(emb_path) and os.path.exists(id_path):
                with open(id_path, "rb") as f:
                    offs = np.asarray(pickle.load(f), np.int64)
                rows = offs.shape[0]
                payload_off, dtype = locate_pickle_payload(emb_path, rows, dim)
                path = emb_path
            else:
                break
            if dtype == np.int8:
                need_quant = True
            order = np.argsort(offs, kind="stable")
            blocks.append(
                _BlockHandle(
                    path=path,
                    payload_off=payload_off,
                    dtype=dtype,
                    rows=rows,
                    start=start,
                    offs=offs,
                    sorted_offs=offs[order],
                    order=order,
                )
            )
            start += rows
            b += 1
        quant = Int8Quantizer.load(data_dir) if need_quant else None
        store = cls(blocks, quant, data_dir)
        store.dim = dim
        return store

    # -- low-level gather ----------------------------------------------
    def _gather_f32(self, blk: _BlockHandle, positions: np.ndarray) -> np.ndarray:
        """Rows at in-block ``positions`` as float32 (int8 dequantized), the
        same cast chain as the streaming pass. Positions are read in sorted
        order (coalesced reads) and un-permuted after."""
        positions = np.asarray(positions, np.int64)
        perm = np.argsort(positions, kind="stable")
        rows = gather_file_rows(blk.path, blk.payload_off, blk.dtype, self.dim, positions[perm])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        rows = rows[inv]
        if rows.dtype == np.int8:
            return rows.astype(np.float32) * self.quantizer.scales[None, :]
        return np.asarray(rows, np.float32)

    def gather_by_position(self, positions: np.ndarray) -> np.ndarray:
        """Rows at global (block-concatenation order) positions, f32.
        Out-of-range positions (including -1 padding) raise."""
        positions = np.asarray(positions, np.int64)
        if positions.size and (positions.min() < 0 or positions.max() >= self.ntotal):
            raise IndexError("candidate position out of range")
        out = np.empty((positions.shape[0], self.dim), np.float32)
        starts = np.asarray([b.start for b in self.blocks], np.int64)
        which = np.searchsorted(starts, positions, side="right") - 1
        for bi, blk in enumerate(self.blocks):
            m = which == bi
            if not m.any():
                continue
            local = positions[m] - blk.start
            if (local < 0).any() or (local >= blk.rows).any():
                raise IndexError("candidate position out of range")
            out[m] = self._gather_f32(blk, local)
        return out

    # -- rescoring contracts -------------------------------------------
    def refine_by_value(
        self, queries: np.ndarray, cand_ids: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``IVFIndex.rescore_block_pass`` semantics at O(candidates) disk
        cost: candidates are emb2offset ROWID VALUES ([Q, C], -1 padded);
        duplicate rowids max-combine over all their rows; missing rowids
        raise. Returns (scores [Q, k] f32 desc, rowids [Q, k] int32), ties
        by lower rowid."""
        q = np.asarray(queries, np.float32)
        cand = np.asarray(cand_ids, np.int64)
        if q.shape[0] != cand.shape[0]:
            raise ValueError("one candidate row per query expected")
        scores = np.full(cand.shape, NEG_INF, np.float32)
        valid = cand >= 0
        for blk in self.blocks:
            if blk.rows == 0:
                continue
            left = np.searchsorted(blk.sorted_offs, cand, side="left")
            right = np.searchsorted(blk.sorted_offs, cand, side="right")
            hit = valid & (right > left)
            if not hit.any():
                continue
            qi, slot = np.nonzero(hit)
            reps = (right - left)[qi, slot]
            qi_e = np.repeat(qi, reps)
            slot_e = np.repeat(slot, reps)
            within = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
            sorted_pos = np.repeat(left[qi, slot], reps) + within
            rows = self._gather_f32(blk, blk.order[sorted_pos])
            s = np.einsum("cd,cd->c", rows, q[qi_e], dtype=np.float32)
            np.maximum.at(scores, (qi_e, slot_e), s)
        missed = int((valid & (scores == NEG_INF)).sum())
        if missed:
            raise ValueError(
                f"{missed} candidate rowids never appeared in "
                f"{self.data_dir}'s emb2offset payloads — these blocks "
                "are not the ones this index was built from"
            )
        return rank_candidate_tail(np.where(valid, scores, NEG_INF), cand, k)

    def refine_positional(
        self,
        queries: np.ndarray,
        cand_pos: np.ndarray,
        k: int,
        *,
        block_sizes: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``PQIndex.rescore_block_pass`` semantics at O(candidates) disk
        cost: candidates are block-concatenation ROW POSITIONS. With
        ``block_sizes`` (the index's ``stats['block_sizes']``) the store's
        block layout is checked against it. Returns (scores, POSITIONS)."""
        if block_sizes is not None:
            mine = [b.rows for b in self.blocks]
            if list(block_sizes) != mine:
                raise ValueError(
                    f"block sizes {mine} in {self.data_dir} do not match "
                    f"the index's build layout {list(block_sizes)}"
                )
        q = np.asarray(queries, np.float32)
        pos = np.asarray(cand_pos, np.int64)
        if q.shape[0] != pos.shape[0]:
            raise ValueError("one candidate row per query expected")
        scores = np.full(pos.shape, NEG_INF, np.float32)
        valid = (pos >= 0) & (pos < self.ntotal)
        if valid.any():
            qi, slot = np.nonzero(valid)
            rows = self.gather_by_position(pos[qi, slot])
            scores[qi, slot] = np.einsum("cd,cd->c", rows, q[qi], dtype=np.float32)
        return rank_candidate_tail(
            np.where(valid, scores, NEG_INF), np.where(valid, pos, -1), k
        )
