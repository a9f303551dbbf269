"""Int8 scalar quantization for embedding storage (FAISS SQ8 counterpart).

The counterpart of ``convdr_tpu/ops/quant.py``: the numpy functions are the
same functions, kept here because the port imports nothing of the JAX
package; :func:`quantize_passages_dev` is the device-side SQ8 of a float
block (the JAX searcher's ``_quantize_block_dev``).

Scheme (symmetric, per-dimension, like FAISS ``QT_8bit_uniform`` per dim):

  passage p  ->  p_i8[d] = clip(round(p[d] / s[d]), -127, 127),
                 s[d] = max_rows |p[:, d]| / 127   (fit on a sample)
  query q    ->  folded = q * s;  t_q = max_d |folded[d]| / 127;
                 q_int[d] = clip(round(folded[d] / t_q), -127, 127)

  score(q, p) ~= t_q * <q_int, p_i8>

Rounding is half to even on both sides (``np.rint``, ``torch.round``).
The per-dimension passage scale folds into the query side, so the device
scan is a plain integer inner product: every product of two int8 values
(<= 127^2) and every partial sum of ``dim <= 1040`` of them (< 2^24) is
exact in f32, so the score kernel's f32 FMAs are integer arithmetic in any
order and the int8 search equals :func:`int8_topk_oracle` bit for bit.
``t_q`` is a per-query positive scalar: it never changes a query's ranking
and only rescales the reported scores.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

INT8_SCALES_FILENAME = "int8_scales.npy"

# dim bound for the bit-exact integer contract: dim * 127^2 < 2^24 keeps
# every partial sum exactly representable in the f32 accumulator.
INT8_EXACT_MAX_DIM = (1 << 24) // (127 * 127)


def fit_int8_scales(sample: np.ndarray) -> np.ndarray:
    """Per-dimension symmetric scales from a sample of passage embeddings
    (the embedding pipeline fits on its first block, an ``i % num_blocks``
    round-robin shard, and clips later blocks' rare out-of-range values)."""
    sample = np.asarray(sample)
    if sample.ndim != 2 or sample.shape[0] == 0:
        raise ValueError(f"need a non-empty [N, D] sample, got {sample.shape}")
    absmax = np.max(np.abs(sample.astype(np.float32)), axis=0)
    # all-zero dimensions carry no signal; scale 1 maps them to 0 safely
    return np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)


def quantize_passages(emb: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """f32 [N, D] -> int8 [N, D] with per-dimension scales (clipped)."""
    emb = np.asarray(emb, np.float32)
    q = np.rint(emb / scales[None, :])
    return np.clip(q, -127, 127).astype(np.int8)


def quantize_passages_dev(p: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Device-side SQ8 of a float block: the same IEEE f32 divide, round
    half to even and clip as :func:`quantize_passages`, so the two are
    bit-identical."""
    q = torch.round(p.float() / scales.float()[None, :])
    return q.clamp_(-127, 127).to(torch.int8)


def quantize_queries(
    queries: np.ndarray, scales: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """f32 [Q, D] -> (int-valued f32 [Q, D], per-query score scale [Q, 1])."""
    q = np.asarray(queries, np.float32) * np.asarray(scales, np.float32)[None, :]
    t = np.max(np.abs(q), axis=1, keepdims=True) / 127.0
    t = np.where(t > 0, t, 1.0).astype(np.float32)
    q_int = np.clip(np.rint(q / t), -127, 127).astype(np.float32)
    return q_int, t


def int8_topk_oracle(
    q_int: np.ndarray, p_i8: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact integer oracle for the quantized search: (integer scores as f32
    [Q, k] desc, indices [Q, k] int32), ties broken by lower passage index."""
    scores = q_int.astype(np.int64) @ p_i8.astype(np.int64).T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, order, axis=1)
    return top.astype(np.float32), order.astype(np.int32)


def rescore_candidates(
    queries: np.ndarray,
    passages: np.ndarray,
    cand_idx: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-rank quantized-search candidates with full-precision scores.

    The FAISS ``IndexRefineFlat`` step, on the host: the quantized scan
    proposes ``cand_idx`` [Q, m] rows (-1 padded), whose float32 inner
    products are recomputed here and the top ``k`` kept. Ties break by
    lower global index: the candidates are index-sorted before the stable
    final sort.
    """
    neg_inf = float(np.finfo(np.float32).min)
    q = np.asarray(queries, np.float32)
    idx = np.asarray(cand_idx, np.int64)
    key = np.where(idx >= 0, idx, np.iinfo(np.int64).max)
    ord0 = np.argsort(key, axis=1, kind="stable")
    idx = np.take_along_axis(idx, ord0, axis=1)
    cand = np.asarray(passages, np.float32)[np.clip(idx, 0, None)]  # [Q,m,D]
    s = np.matmul(cand, q[:, :, None])[:, :, 0]  # [Q, m]
    s = np.where(idx >= 0, s, neg_inf).astype(np.float32)
    kk = min(k, s.shape[1])
    sel = np.argsort(-s, axis=1, kind="stable")[:, :kk]
    out_s = np.take_along_axis(s, sel, axis=1)
    out_i = np.take_along_axis(idx, sel, axis=1).astype(np.int32)
    if kk < k:
        out_s = np.pad(out_s, ((0, 0), (0, k - kk)), constant_values=neg_inf)
        out_i = np.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    out_i = np.where(out_s <= neg_inf, -1, out_i)
    return out_s, out_i


class Int8Quantizer:
    """Fitted per-dimension scales; persisted next to the embedding blocks
    as ``int8_scales.npy``, which the searcher folds into the queries."""

    def __init__(self, scales: np.ndarray):
        self.scales = np.asarray(scales, np.float32)
        if self.scales.ndim != 1:
            raise ValueError(f"scales must be [D], got {self.scales.shape}")

    @classmethod
    def fit(cls, sample: np.ndarray) -> "Int8Quantizer":
        return cls(fit_int8_scales(sample))

    def quantize_passages(self, emb: np.ndarray) -> np.ndarray:
        return quantize_passages(emb, self.scales)

    def quantize_queries(self, queries: np.ndarray):
        return quantize_queries(queries, self.scales)

    def save(self, data_dir: str) -> str:
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, INT8_SCALES_FILENAME)
        np.save(path, self.scales)
        return path

    @classmethod
    def load(cls, data_dir: str) -> "Int8Quantizer":
        path = os.path.join(data_dir, INT8_SCALES_FILENAME)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"int8 blocks need their scales sidecar; {path} is missing "
                "(written by generate_embeddings(storage_dtype='int8'))"
            )
        return cls(np.load(path))

    @classmethod
    def load_optional(cls, data_dir: str) -> Optional["Int8Quantizer"]:
        try:
            return cls.load(data_dir)
        except FileNotFoundError:
            return None
