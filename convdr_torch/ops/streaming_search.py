"""Streaming exact search: the top-k without the [Q, N] score matrix.

The counterpart of the streaming half of ``convdr_tpu/ops/pallas_search.py``
(lines 349-609):

  * :func:`streaming_groupmax`       -- pass A, the [Q, N/G] group maxima in
    one passage pass (the score kernel with its score store compiled out,
    ``convdr_streaming_groupmax`` in ``csrc/scores_groupmax.cu``);
  * :func:`extract_candidate_scores` -- pass B, the [Q, kg, G] scores of the
    selected groups only (``csrc/streaming_search.cu``);
  * :func:`streaming_flat_ip_topk`   -- group selection on the maxima, pass
    B, and the final stable top-k: the contract of
    :func:`~convdr_torch.ops.exact_search.flat_ip_topk`.

Both passes compute each score as one sequential f32 FMA chain over the
dimension, as the score kernel does, so pass A's maxima are bit-identical
to the score kernel's and pass B's scores to its scores: the group pruning
is exact and the top-k equals :func:`flat_ip_topk`'s bit for bit on the
card. The TPU version's ``tile_rows`` and ``query_tile`` only sized its
VMEM blocks; they have no counterpart here and the results do not depend
on them. Passages may be f32, bf16 or int8 (with the int-valued queries of
``quantize_queries``), as for the score kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import NEG_INF, grouped_topk_last_axis
from convdr_torch.ops.fused_search import (
    GROUPS,
    ROW_TILE,
    _P_DTYPE_CODES,
    check_score_operands,
    fused_scores_groupmax_plain,
    kernel_operands,
)

# The plain pass B gathers the selected rows of this many bytes at a time.
_PLAIN_CHUNK_BYTES = 256 << 20


def streaming_groupmax_plain(
    queries: torch.Tensor, passages: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """Group maxima [Q, N/group] in PyTorch: an f32 matmul, then ``amax``."""
    return fused_scores_groupmax_plain(queries, passages, group)[1]


def streaming_groupmax(
    queries: torch.Tensor, passages: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """Group maxima [Q, N/group] f32; the scores never reach device memory.

    CUDA tensors go through ``csrc/scores_groupmax.cu``
    (``convdr_streaming_groupmax``; passages f32, bf16 or int8, N a multiple
    of :data:`~convdr_torch.ops.fused_search.ROW_TILE`, ``group`` in
    :data:`~convdr_torch.ops.fused_search.GROUPS`); CPU tensors through
    :func:`streaming_groupmax_plain`. ``streaming_groupmax.launches``
    counts kernel launches.
    """
    if passages.device.type == "cpu":
        return streaming_groupmax_plain(queries, passages, group)
    check_score_operands("streaming_groupmax", queries, passages, group)
    q, p = kernel_operands(queries, passages)
    qn, d = q.shape
    n = p.shape[0]
    gmax = torch.empty((qn, n // group), dtype=torch.float32, device=passages.device)
    fn = cuda_build.load("scores_groupmax").convdr_streaming_groupmax
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(passages.device):
        rc = fn(
            q.data_ptr(), p.data_ptr(), gmax.data_ptr(), qn, n, d, group,
            _P_DTYPE_CODES[passages.dtype],
            torch.cuda.current_stream(passages.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"streaming_groupmax kernel launch failed: CUDA error {rc}")
    streaming_groupmax.launches += 1
    return gmax


streaming_groupmax.launches = 0


def _check_group_ids(gsel: torch.Tensor, n_groups: int) -> None:
    """Raise IndexError unless every id of ``gsel`` is in [0, n_groups)."""
    if gsel.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(gsel)).tolist()
    if lo < 0 or hi >= n_groups:
        raise IndexError(
            f"gsel holds group ids in [{lo}, {hi}]; the passages have "
            f"{n_groups} groups"
        )


def extract_candidate_scores_plain(
    queries: torch.Tensor, passages: torch.Tensor, gsel: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """cand [Q, kg, group] f32 in PyTorch: the selected rows gathered (a
    few queries at a time) and multiplied with their query in f32."""
    _check_group_ids(gsel, passages.shape[0] // group)
    qn, kg = gsel.shape
    d = queries.shape[1]
    out = torch.empty((qn, kg, group), dtype=torch.float32, device=passages.device)
    offs = torch.arange(group, device=passages.device)
    step = max(1, _PLAIN_CHUNK_BYTES // max(1, kg * group * d * 4))
    for lo in range(0, qn, step):
        rows = gsel[lo : lo + step, :, None].long() * group + offs  # [c, kg, G]
        cand = passages[rows].float()  # [c, kg, G, D]
        out[lo : lo + step] = torch.matmul(
            cand, queries[lo : lo + step, None, :, None].float()
        )[..., 0]
    return out


def extract_candidate_scores(
    queries: torch.Tensor, passages: torch.Tensor, gsel: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """cand [Q, kg, group] f32 with cand[q, j] the scores of rows
    ``gsel[q, j] * group ...`` of ``passages``: pass B of the streaming
    search. ``gsel`` [Q, kg] holds group ids in [0, N / group); any other
    id raises IndexError, on the card as on the CPU.

    CUDA tensors go through ``csrc/streaming_search.cu`` (the same operand
    rules as :func:`streaming_groupmax`); CPU tensors through
    :func:`extract_candidate_scores_plain`. The wrapper sorts the Q * kg
    (query, group) slots by group so that the kernel reads each selected
    group once. ``extract_candidate_scores.launches`` counts kernel launches.
    """
    if passages.device.type == "cpu":
        return extract_candidate_scores_plain(queries, passages, gsel, group)
    check_score_operands("extract_candidate_scores", queries, passages, group)
    if gsel.dim() != 2 or gsel.shape[0] != queries.shape[0] or gsel.device != passages.device:
        raise ValueError(
            f"gsel must be [Q, kg] on {passages.device}, got {tuple(gsel.shape)} "
            f"on {gsel.device}"
        )
    qn, d = queries.shape
    kg = gsel.shape[1]
    n_groups = passages.shape[0] // group
    _check_group_ids(gsel, n_groups)
    cand = torch.empty((qn, kg, group), dtype=torch.float32, device=passages.device)
    if cand.numel() == 0:
        return cand
    q = queries.to(torch.float32).contiguous()
    by_group, slots = torch.sort(gsel.reshape(-1).long())
    starts = torch.searchsorted(
        by_group, torch.arange(n_groups + 1, device=passages.device)
    ).to(torch.int32)
    slots = slots.to(torch.int32)
    fn = cuda_build.load("streaming_search").convdr_extract_candidates
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(passages.device):
        rc = fn(
            q.data_ptr(), passages.data_ptr(), slots.data_ptr(), starts.data_ptr(),
            cand.data_ptr(), n_groups, d, kg, group, _P_DTYPE_CODES[passages.dtype],
            torch.cuda.current_stream(passages.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"extract_candidate_scores kernel launch failed: CUDA error {rc}"
        )
    extract_candidate_scores.launches += 1
    return cand


extract_candidate_scores.launches = 0


def streaming_flat_ip_topk(
    queries: torch.Tensor,
    passages: torch.Tensor,
    k: int,
    *,
    group: int = 128,
    valid_rows: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FlatIP top-k that never materializes the [Q, N] score matrix.

    Pass A's group maxima pick ``k`` candidate groups (+1 absorber when
    rows are masked: a group straddling the valid count may be picked for
    its masked tail) by the stable recursive top-k, the group ids sort
    ascending so candidates stay in global index order, pass B scores the
    selected groups, rows past the valid count are masked, and the final
    stable top-k recovers indices from candidate positions. Same contract
    as :func:`~convdr_torch.ops.exact_search.flat_ip_topk`: (scores [Q, k]
    f32 desc, indices [Q, k] int64), lower index first on ties, (NEG_INF,
    -1) past the valid rows. Rows are zero-padded to
    :data:`~convdr_torch.ops.fused_search.ROW_TILE` when needed.
    """
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    qn = queries.shape[0]
    n = passages.shape[0]
    valid = None if valid_rows < 0 else int(valid_rows)
    pad = (-n) % ROW_TILE
    if pad:
        passages = F.pad(passages, (0, 0, 0, pad))
        if valid is None:
            valid = n
    n_groups = passages.shape[0] // group
    k_eff = min(k, n)

    gmax = streaming_groupmax(queries, passages, group)  # [Q, NG]
    k_grp = min(k_eff + (0 if valid is None else 1), n_groups)
    if valid is not None:
        group_start = torch.arange(n_groups, device=gmax.device) * group
        gmax = gmax.masked_fill(group_start[None, :] >= valid, NEG_INF)
    _, gsel = grouped_topk_last_axis(gmax, k_grp, 32)
    gsel, _ = torch.sort(gsel, dim=-1)  # ascending group ids => global order

    cand = extract_candidate_scores(queries, passages, gsel, group)  # [Q, kg, G]
    if valid is not None:
        cand_idx = gsel[:, :, None] * group + torch.arange(group, device=cand.device)
        cand = cand.masked_fill(cand_idx >= valid, NEG_INF)
    top_s, sel = grouped_topk_last_axis(cand.reshape(qn, -1), k_eff, 32)
    top_i = torch.gather(gsel, 1, sel // group) * group + sel % group
    if k_eff < k:
        top_s = F.pad(top_s, (0, k - k_eff), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - k_eff), value=-1)
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_s, top_i
