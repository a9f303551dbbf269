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

Both passes compute each score as the score kernel does (f32 passages:
the six-part tensor-core product of the queries' and the passages' bf16
parts into two sums, in one k order; bf16: the three-part product of the
queries' bf16 parts, in one k order; int8: exact integer sums), so pass
A's maxima are bit-identical to the score kernel's
and pass B's scores to its scores: the group pruning is exact and the
top-k equals :func:`flat_ip_topk`'s bit for bit on the card. On the card
:func:`streaming_flat_ip_topk` issues no host sync. The TPU version's
``tile_rows`` and ``query_tile`` only sized its VMEM blocks; they have no
counterpart here and the results do not depend on them. Passages may be f32, bf16 or int8 (with the int-valued queries of
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
    bf16_query_parts,
    check_score_operands,
    fused_scores_groupmax_plain,
    kernel_operands,
)

# The plain pass B gathers the selected rows of this many bytes at a time.
_PLAIN_CHUNK_BYTES = 256 << 20
# Slots of one pass-B work item (``kTM`` in ``csrc/streaming_search.cu``).
ITEM_SLOTS = 16
_IDX_BYTES = {torch.int32: 4, torch.int64: 8}
_GROUPMAX_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LIST_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
)
_PASS_B_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)


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
    qn = q.shape[-2]  # above the small-Q limit: the queries' parts [3, Q, D]
    n, d = p.shape
    gmax = torch.empty((qn, n // group), dtype=torch.float32, device=passages.device)
    fn = cuda_build.bind("scores_groupmax", "convdr_streaming_groupmax", _GROUPMAX_ARGTYPES)
    rc = cuda_build.launch(
        fn, passages.device, q.data_ptr(), p.data_ptr(), gmax.data_ptr(), qn, n, d,
        group, _P_DTYPE_CODES[passages.dtype],
    )
    if rc != 0:
        raise RuntimeError(f"streaming_groupmax kernel launch failed: CUDA error {rc}")
    streaming_groupmax.launches += 1
    return gmax


streaming_groupmax.launches = 0


def _raise_unless_in_range(lo: int, hi: int, n_groups: int) -> None:
    if lo < 0 or hi >= n_groups:
        raise IndexError(
            f"gsel holds group ids in [{lo}, {hi}]; the passages have "
            f"{n_groups} groups"
        )


def _check_group_ids(gsel: torch.Tensor, n_groups: int) -> None:
    """Raise IndexError unless every id of ``gsel`` is in [0, n_groups)."""
    if gsel.numel() == 0:
        return
    _raise_unless_in_range(*torch.stack(torch.aminmax(gsel)).tolist(), n_groups)


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


def _f32_rows(x: torch.Tensor) -> torch.Tensor:
    """Contiguous f32 rows of a multiple of 16 bytes from a 16-byte aligned
    base, as the f32 pass B loads them: D zero-padded to 4 (zeros after the
    last k leave every score as it was), an unaligned tensor copied."""
    pad = (-x.shape[1]) % 4
    if pad:
        x = F.pad(x, (0, pad))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _work_list_size(n_groups: int, n_slots: int) -> Tuple[int, int]:
    """(U, workspace int32 values): U = min(n_groups, S) + S // ITEM_SLOTS
    bounds the number of items (a group of c slots has ceil(c / ITEM_SLOTS)
    of them), and the workspace of ``csrc/streaming_search.cu`` holds
    counts and cursors [n_groups] each, the slots [S], the items [U, 3] and
    their number."""
    bound = min(n_groups, n_slots) + n_slots // ITEM_SLOTS
    return bound, 2 * n_groups + n_slots + 3 * bound + 1


def candidate_work_list_plain(
    gsel: torch.Tensor, n_groups: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`candidate_work_list` in PyTorch: a sort of the slots by group
    id, and a cut of each group's run into items."""
    flat = gsel.reshape(-1)
    n = flat.numel()
    by_group, slots = torch.sort(flat)
    pos = torch.arange(n, dtype=torch.int32, device=flat.device)
    first = torch.searchsorted(by_group, by_group, out_int32=True)  # group begins
    last = torch.searchsorted(by_group, by_group, right=True, out_int32=True)
    head = (pos - first) % ITEM_SLOTS == 0  # an item begins here
    item = torch.cumsum(head, 0, dtype=torch.int32)  # 1-based item number
    bound = _work_list_size(n_groups, n)[0]
    row = torch.where(head, item - 1, bound).long()  # non-heads: a dropped row
    vals = torch.stack((by_group.int(), pos, (last - pos).clamp_(max=ITEM_SLOTS)), 1)
    items = torch.zeros((bound + 1, 3), dtype=torch.int32, device=flat.device)
    items.scatter_(0, row[:, None].expand(-1, 3), vals)
    return slots.int(), items[:bound], item[-1:]


def candidate_work_list(
    gsel: torch.Tensor, n_groups: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass B's work list: the Q * kg slots (s = query * kg + j) of
    ``gsel`` [Q, kg] (ids in [0, n_groups)) bucketed by group, each group's
    slots cut into items of at most :data:`ITEM_SLOTS`.

    Returns ``(slots, items, n_items)``: ``slots`` int32 [Q * kg], the slot
    ids in group order; ``items`` int32 [U, 3], (group, first position in
    ``slots``, count) of item i in its row i, in group order, U an upper
    bound on their number known from the shapes (:func:`_work_list_size`);
    ``n_items`` int32 [1], the number of valid rows of ``items`` (those
    past it are unspecified). CUDA tensors go through the counting sort of
    ``csrc/streaming_search.cu`` (no host sync; slots in an order within a
    group that may change from call to call), which
    :func:`extract_candidate_scores` runs itself; CPU tensors through
    :func:`candidate_work_list_plain`. ``candidate_work_list.launches``
    counts this function's launches (not those inside pass B).
    """
    if gsel.device.type == "cpu":
        return candidate_work_list_plain(gsel, n_groups)
    if gsel.dim() != 2 or gsel.dtype not in _IDX_BYTES:
        raise ValueError(f"gsel must be [Q, kg] int32 or int64, got {gsel.dtype}")
    ids = gsel if gsel.is_contiguous() else gsel.contiguous()
    qn, kg = ids.shape
    n = qn * kg
    bound, size = _work_list_size(n_groups, n)
    ws = torch.empty(size, dtype=torch.int32, device=gsel.device)
    fn = cuda_build.bind("streaming_search", "convdr_candidate_work_list", _LIST_ARGTYPES)
    rc = cuda_build.launch(
        fn, gsel.device, ids.data_ptr(), _IDX_BYTES[ids.dtype], ws.data_ptr(), qn, kg,
        n_groups, bound,
    )
    if rc != 0:
        raise RuntimeError(f"candidate_work_list kernel launch failed: CUDA error {rc}")
    candidate_work_list.launches += 1
    at = 2 * n_groups
    items = ws[at + n : at + n + 3 * bound].view(bound, 3)
    return ws[at : at + n], items, ws[at + n + 3 * bound :]


candidate_work_list.launches = 0


def extract_candidate_scores_unchecked(
    queries: torch.Tensor, passages: torch.Tensor, gsel: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """:func:`extract_candidate_scores` without its range check of
    ``gsel``, so without the host sync the check needs: for callers whose
    ids are in [0, N / group) by construction (:func:`streaming_flat_ip_topk`).
    On the card the scores of a slot with an id out of range are left
    unwritten. It launches the same kernel and counts in
    ``extract_candidate_scores.launches``; CPU tensors take
    :func:`extract_candidate_scores_plain`."""
    if passages.device.type == "cpu":
        return extract_candidate_scores_plain(queries, passages, gsel, group)
    check_score_operands("extract_candidate_scores", queries, passages, group)
    if (gsel.dim() != 2 or gsel.shape[0] != queries.shape[0]
            or gsel.device != passages.device or gsel.dtype not in _IDX_BYTES):
        raise ValueError(
            f"gsel must be [Q, kg] int32 or int64 on {passages.device}, got "
            f"{tuple(gsel.shape)} {gsel.dtype} on {gsel.device}"
        )
    qn, d = queries.shape
    kg = gsel.shape[1]
    cand = torch.empty((qn, kg, group), dtype=torch.float32, device=passages.device)
    if cand.numel() == 0:
        return cand
    # int8 passages take the int-valued queries as int8, bf16 passages the
    # queries' three bf16 parts, as kernel 2 does; f32 passages the f32
    # queries, which the kernel splits, both in 16-byte rows and bases (the
    # kernel loads the passage rows by TMA): D zero-padded to 4, an
    # unaligned operand copied
    q = queries.to(torch.float32)
    if passages.dtype == torch.int8:
        q = q.to(torch.int8)
    elif passages.dtype == torch.bfloat16:
        q = bf16_query_parts(q)
    else:
        q, passages = _f32_rows(q), _f32_rows(passages)
        d = passages.shape[1]
    if not q.is_contiguous():
        q = q.contiguous()
    ids = gsel if gsel.is_contiguous() else gsel.contiguous()
    n_groups = passages.shape[0] // group
    bound, size = _work_list_size(n_groups, qn * kg)
    ws = torch.empty(size, dtype=torch.int32, device=passages.device)
    fn = cuda_build.bind("streaming_search", "convdr_extract_candidates", _PASS_B_ARGTYPES)
    rc = cuda_build.launch(
        fn, passages.device, q.data_ptr(), passages.data_ptr(), ids.data_ptr(),
        _IDX_BYTES[ids.dtype], ws.data_ptr(), cand.data_ptr(), qn, kg, n_groups, bound,
        d, group, _P_DTYPE_CODES[passages.dtype],
    )
    if rc != 0:
        raise RuntimeError(
            f"extract_candidate_scores kernel launch failed: CUDA error {rc}"
        )
    extract_candidate_scores.launches += 1
    return cand


def extract_candidate_scores(
    queries: torch.Tensor, passages: torch.Tensor, gsel: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """cand [Q, kg, group] f32 with cand[q, j] the scores of rows
    ``gsel[q, j] * group ...`` of ``passages``: pass B of the streaming
    search. ``gsel`` [Q, kg] holds group ids in [0, N / group); any other
    id raises IndexError, on the card as on the CPU. On the card the check
    reads the ids' range back after the kernel is queued, so it waits for
    the kernel rather than the kernel for it.

    CUDA tensors go through ``csrc/streaming_search.cu`` (the same operand
    rules as :func:`streaming_groupmax`, any D), which builds its own work
    list (:func:`candidate_work_list`); CPU tensors through
    :func:`extract_candidate_scores_plain`.
    ``extract_candidate_scores.launches`` counts kernel launches.
    """
    if passages.device.type == "cpu":
        return extract_candidate_scores_plain(queries, passages, gsel, group)
    bounds = torch.stack(torch.aminmax(gsel)) if gsel.numel() else None
    cand = extract_candidate_scores_unchecked(queries, passages, gsel, group)
    if bounds is not None:
        _raise_unless_in_range(*bounds.tolist(), passages.shape[0] // group)
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

    # ids from the top-k above are in range: no check, no host sync
    cand = extract_candidate_scores_unchecked(queries, passages, gsel, group)  # [Q, kg, G]
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
