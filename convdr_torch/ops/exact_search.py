"""Exact inner-product top-k search (the FAISS ``IndexFlatIP`` replacement).

The counterpart of ``convdr_tpu/ops/exact_search.py``:

  * :func:`topk_oracle`     -- numpy reference implementation (test oracle);
  * :func:`flat_ip_topk`    -- blocked scan: per block, the fused score +
    group-max kernel (:mod:`convdr_torch.ops.fused_search`), then an exact
    top-k through group-max candidate selection; O(k) running state;
  * :func:`~convdr_torch.ops.streaming_search.streaming_flat_ip_topk` --
    the same top-k without the [Q, N] score matrix (two passes);
  * :func:`merge_topk`      -- stable merge of sorted candidate lists with
    the reference's tie rule (earlier block / lower passage index wins,
    run_convdr_inference.py:217-229).

Exactness contract: scores are accumulated in f32 whatever the storage
dtype, with no TF32 (:func:`convdr_torch.core.device.set_exact_matmul`);
ordering is (score desc, candidate index asc), which matches FAISS FlatIP,
so recall@k is bit-identical to the oracle. ``torch.topk`` does not specify
its tie order, so every selection here is a stable descending
``torch.sort``, and selected group ids are sorted ascending before their
candidates are gathered, which keeps candidates in global index order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from convdr_torch.core.config import NOT_PORTED
from convdr_torch.ops.gather_groups import dma_gather_groups

NEG_INF = float(np.finfo(np.float32).min)

# The JAX package's matmul precisions (``SearchConfig.matmul_precision``).
# Only "highest" (full f32, oracle-exact) is ported; on the card the others
# would be TF32 and bf16 products.
_PRECISIONS = ("default", "high", "highest")

# Widths at or below this go straight to a stable sort; above it, group-prune
# recursively, so no selection sort is wider than max(4096, k * group).
_TOPK_BASE_WIDTH = 4096


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------
def topk_oracle(
    queries: np.ndarray, passages: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k by full argsort; ties broken by lower passage index.

    Returns (scores [Q, k] f32 desc, indices [Q, k] int32). Rows beyond the
    corpus size are filled with (NEG_INF, -1).
    """
    q = queries.astype(np.float32)
    p = passages.astype(np.float32)
    scores = q @ p.T  # [Q, N]
    n = scores.shape[1]
    kk = min(k, n)
    # stable sort on -score keeps lower index first among equals
    order = np.argsort(-scores, axis=1, kind="stable")[:, :kk]
    top_s = np.take_along_axis(scores, order, axis=1)
    if kk < k:
        pad_s = np.full((scores.shape[0], k - kk), NEG_INF, np.float32)
        pad_i = np.full((scores.shape[0], k - kk), -1, np.int64)
        top_s = np.concatenate([top_s, pad_s], axis=1)
        order = np.concatenate([order, pad_i], axis=1)
    return top_s.astype(np.float32), order.astype(np.int32)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------
def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, values desc, lower index first on ties."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _gather_groups(x3: torch.Tensor, gsel: torch.Tensor) -> torch.Tensor:
    """x3[q, gsel[q, j], :] -> [Q, kg, G] (an exact copy of the groups)."""
    return torch.gather(
        x3, 1, gsel[:, :, None].expand(-1, -1, x3.shape[2])
    )


def _gather_candidate_groups(
    s3: torch.Tensor, gsel: torch.Tensor, gather: str
) -> torch.Tensor:
    """s3[q, gsel[q, j], :] -> [Q, kg, G], the candidate groups of a block.

    CUDA tensors always go through the hand-written gather kernel
    (:func:`convdr_torch.ops.gather_groups.dma_gather_groups`, the
    counterpart of the JAX ``gather="dma"``); CPU tensors through
    ``torch.gather``. ``gather`` is checked for parity with the JAX
    signature ("auto", "onehot" or "dma") and selects no code: the JAX
    package's one-hot MXU matmul has no reason to exist on a GPU, and all
    three copy the same values.
    """
    if gather not in ("auto", "onehot", "dma"):
        raise ValueError(f"unknown gather impl {gather!r}")
    if s3.device.type == "cpu":
        return _gather_groups(s3, gsel)
    qn, n_groups, g = s3.shape
    return dma_gather_groups(s3.reshape(qn, n_groups * g), gsel, group=g)


def grouped_topk_last_axis(
    x: torch.Tensor, k: int, group: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis with RECURSIVE group pruning.

    Same contract as :func:`stable_topk`, but the wide sort is replaced by
    per-group maxima, a recursive top-k over them, a gather of the k
    selected groups (ids sorted ascending) and a final k*G-wide sort. Any
    top-k element lives in one of the k top-ranked groups (k groups with
    larger-or-tied-earlier maxima would otherwise each hold an element
    ranked above it), so pruning never drops a needed candidate.
    """
    qn, w = x.shape
    n_groups = -(-w // group)
    if w <= max(_TOPK_BASE_WIDTH, 2 * k) or n_groups <= k:
        return stable_topk(x, k)
    pad = n_groups * group - w
    if pad:
        x = F.pad(x, (0, pad), value=NEG_INF)
    x3 = x.view(qn, n_groups, group)
    gmax = x3.amax(dim=-1)
    _, gsel = grouped_topk_last_axis(gmax, min(k, n_groups), group)
    gsel, _ = torch.sort(gsel, dim=-1)  # ascending group ids => global order
    cand = _gather_groups(x3, gsel)  # [Q, k, G]
    top_s, sel = grouped_topk_last_axis(cand.reshape(qn, -1), k, group)
    grp_ids = torch.gather(gsel, 1, sel // group)
    return top_s, grp_ids * group + sel % group


def select_from_groupmax(
    s3: torch.Tensor,
    group_max: torch.Tensor,
    k: int,
    group: int,
    valid: Optional[int] = None,
    *,
    gather: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection given grouped scores [Q, NG, G] + maxima [Q, NG].

    Stable top-k of the maxima picks candidate groups (+1 absorber when
    validity-masked: a group straddling ``valid`` may be picked for its
    masked tail), group ids sort ascending to preserve the global tie
    order, the groups are gathered (by the gather kernel on the card; see
    :func:`_gather_candidate_groups` for ``gather``), and indices are
    recovered from the final stable top-k's positions.
    """
    qn, n_groups, _g = s3.shape
    k_grp = k
    if valid is not None:
        group_start = torch.arange(n_groups, device=s3.device) * group
        group_max = group_max.masked_fill(group_start[None, :] >= valid, NEG_INF)
        k_grp = k + 1  # absorb a spurious straddling-group selection
    k_grp = min(k_grp, n_groups)
    _, gsel = grouped_topk_last_axis(group_max, k_grp, group)
    gsel, _ = torch.sort(gsel, dim=-1)  # ascending group ids => global order
    cand = _gather_candidate_groups(s3, gsel, gather)  # [Q, kg, G]
    if valid is not None:
        cand_idx = gsel[:, :, None] * group + torch.arange(
            group, device=s3.device
        )[None, None, :]
        cand = cand.masked_fill(cand_idx >= valid, NEG_INF)
    top_s, sel = grouped_topk_last_axis(cand.reshape(qn, -1), k, group)
    grp_ids = torch.gather(gsel, 1, sel // group)
    return top_s, grp_ids * group + sel % group


def merge_topk(
    s_a: torch.Tensor,
    i_a: torch.Tensor,
    s_b: torch.Tensor,
    i_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted-desc candidate lists; list A wins ties.

    Equivalent to the reference's 2-pointer merge with ``>=`` on the earlier
    list (run_convdr_inference.py:217-229): concatenating A before B and
    taking a stable top-k yields the identical selection and order.
    """
    cat_s = torch.cat([s_a, s_b], dim=1)
    cat_i = torch.cat([i_a, i_b], dim=1)
    top_s, sel = stable_topk(cat_s, k)
    return top_s, torch.gather(cat_i, 1, sel)


# ---------------------------------------------------------------------------
# blocked search
# ---------------------------------------------------------------------------
def flat_ip_topk(
    queries: torch.Tensor,
    passages: torch.Tensor,
    k: int,
    *,
    block_rows: int = 65536,
    valid_rows: int = -1,
    precision: str = "highest",
    group: int = 32,
    gather: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FlatIP top-k: scan over row blocks of the passage matrix.

    queries  [Q, D] (any float dtype; scored as f32)
    passages [N, D] (f32 or bf16 storage; f32 accumulation).
        int8 passages select the SQ8 path (:mod:`convdr_torch.ops.quant`):
        queries must then be the int-valued f32 rows of
        ``quantize_queries``, and the scores are unscaled integer inner
        products, equal to ``int8_topk_oracle``'s bit for bit (the f32
        products and sums of int8 values are exact at dim <= 1040).
    valid_rows: logical corpus size if ``passages`` is padded (-1 = N).
    precision: "highest" (full f32, the default and the only one ported);
        "high" and "default" raise, unless the passages are int8, where it
        is ignored as in the JAX package.
    gather: "auto", "onehot" or "dma", accepted for parity with the JAX
        signature; it selects no code (:func:`_gather_candidate_groups`).

    Returns (scores [Q, k] f32 desc, indices [Q, k] int64, -1 padded).
    Memory: one [Q, block_rows] f32 score block + O(Q*k) running state.
    """
    from convdr_torch.ops.fused_search import fused_flat_ip_topk

    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown matmul precision {precision!r}; choose one of {list(_PRECISIONS)}"
        )
    if precision != "highest" and passages.dtype != torch.int8:
        raise NotImplementedError(f"flat_ip_topk precision={precision!r} {NOT_PORTED}")

    n = passages.shape[0]
    valid = n if valid_rows < 0 else min(int(valid_rows), n)
    k_eff = min(k, n)
    block_rows = max(1, min(block_rows, n))
    out_s = out_i = None
    for lo in range(0, n, block_rows):
        hi = min(n, lo + block_rows)
        blk_valid = min(max(valid - lo, 0), hi - lo)
        blk_s, blk_i = fused_flat_ip_topk(
            queries,
            passages[lo:hi],
            min(k_eff, block_rows),
            group=group,
            valid_rows=-1 if blk_valid == hi - lo else blk_valid,
            gather=gather,
        )
        blk_i = torch.where(blk_i >= 0, blk_i + lo, blk_i)
        if out_s is None:
            out_s, out_i = blk_s, blk_i
            if out_s.shape[1] < k_eff:
                # k > block_rows: widen the running list so later merges
                # can reach k_eff
                pad = k_eff - out_s.shape[1]
                out_s = F.pad(out_s, (0, pad), value=NEG_INF)
                out_i = F.pad(out_i, (0, pad), value=-1)
        else:
            # running list first => earlier blocks win ties
            out_s, out_i = merge_topk(out_s, out_i, blk_s, blk_i, k_eff)
    if out_s is None:  # empty corpus
        qn = queries.shape[0]
        out_s = torch.empty((qn, 0), dtype=torch.float32, device=queries.device)
        out_i = torch.empty((qn, 0), dtype=torch.int64, device=queries.device)
    if k_eff < k:
        out_s = F.pad(out_s, (0, k - k_eff), value=NEG_INF)
        out_i = F.pad(out_i, (0, k - k_eff), value=-1)
    # Padded/invalid slots report index -1.
    out_i = torch.where(out_s == NEG_INF, torch.full_like(out_i, -1), out_i)
    return out_s, out_i
