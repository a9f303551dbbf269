"""Inner-product scores with a fused group-max epilogue: the hand-written
CUDA kernel, its plain PyTorch version, and the single-shot top-k on it.

The counterpart of ``convdr_tpu/ops/pallas_search.py`` lines 93-228
(``fused_scores_groupmax`` and ``pallas_flat_ip_topk``). On the card this is
the score stage of the port's exact search (:func:`convdr_torch.ops.
exact_search.flat_ip_topk`): the kernel writes the [Q, N] f32 scores and the
[Q, N/G] group maxima in one pass, and the candidate selection stays in
PyTorch (:func:`~convdr_torch.ops.exact_search.select_from_groupmax`), as the
JAX kernel leaves it to XLA. G = 32 is the group of the JAX package's XLA
search path (``exact_search._chunked_topk``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import NEG_INF, select_from_groupmax

# Passage rows per kernel tile; the kernel takes N % ROW_TILE == 0 and the
# callers pad rows to it (padded rows are masked through ``valid_rows``).
ROW_TILE = 128
GROUPS = (8, 16, 32, 64, 128)
_P_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_scores_groupmax_plain(
    queries: torch.Tensor, passages: torch.Tensor, group: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, N] f32, group maxima [Q, N/group] f32) in PyTorch: an
    f32 matmul of f32 queries and f32-upcast passages, then a max over each
    run of ``group`` columns."""
    n = passages.shape[0]
    if n % group:
        raise ValueError(f"rows {n} not a multiple of group {group}")
    scores = torch.matmul(queries.float(), passages.float().T)
    gmax = scores.view(scores.shape[0], n // group, group).amax(dim=-1)
    return scores, gmax


def fused_scores_groupmax(
    queries: torch.Tensor, passages: torch.Tensor, group: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, N] f32, group maxima [Q, N/group] f32).

    CUDA tensors go through ``csrc/scores_groupmax.cu`` (passages f32 or
    bf16, N a multiple of :data:`ROW_TILE`, ``group`` in :data:`GROUPS`);
    CPU tensors through :func:`fused_scores_groupmax_plain`.
    ``fused_scores_groupmax.launches`` counts kernel launches.
    """
    if passages.device.type == "cpu":
        return fused_scores_groupmax_plain(queries, passages, group)
    if passages.device.type != "cuda" or queries.device != passages.device:
        raise ValueError(
            f"fused_scores_groupmax: queries on {queries.device}, passages "
            f"on {passages.device}; both must be on one CUDA device"
        )
    if queries.dim() != 2 or passages.dim() != 2:
        raise ValueError("fused_scores_groupmax wants [Q, D] and [N, D]")
    qn, d = queries.shape
    n = passages.shape[0]
    if passages.shape[1] != d:
        raise ValueError(f"dims differ: queries {d}, passages {passages.shape[1]}")
    if n % ROW_TILE:
        raise ValueError(f"rows {n} not a multiple of the tile {ROW_TILE}")
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    if passages.dtype not in _P_DTYPE_CODES:
        raise ValueError(f"passages must be f32 or bf16, got {passages.dtype}")
    if not passages.is_contiguous():
        raise ValueError("fused_scores_groupmax needs contiguous passages")
    q = queries.to(torch.float32).contiguous()
    scores = torch.empty((qn, n), dtype=torch.float32, device=passages.device)
    gmax = torch.empty((qn, n // group), dtype=torch.float32, device=passages.device)
    fn = cuda_build.load("scores_groupmax").convdr_scores_groupmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(passages.device):
        rc = fn(
            q.data_ptr(), passages.data_ptr(), scores.data_ptr(),
            gmax.data_ptr(), qn, n, d, group, _P_DTYPE_CODES[passages.dtype],
            torch.cuda.current_stream(passages.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_scores_groupmax kernel launch failed: CUDA error {rc}"
        )
    fused_scores_groupmax.launches += 1
    return scores, gmax


fused_scores_groupmax.launches = 0


def fused_flat_ip_topk(
    queries: torch.Tensor,
    passages: torch.Tensor,
    k: int,
    *,
    group: int = 32,
    valid_rows: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FlatIP top-k of one passage block through the fused kernel.

    Same contract as :func:`convdr_torch.ops.exact_search.flat_ip_topk`
    (score desc, lower index first on ties; slots past the valid rows hold
    (NEG_INF, -1)). Rows are zero-padded to :data:`ROW_TILE` when needed
    and masked through ``valid_rows``.
    """
    qn = queries.shape[0]
    n = passages.shape[0]
    valid = None if valid_rows < 0 else int(valid_rows)
    pad = (-n) % ROW_TILE
    if pad:
        passages = F.pad(passages, (0, 0, 0, pad))
        if valid is None:
            valid = n
    n_padded = passages.shape[0]
    scores, gmax = fused_scores_groupmax(queries, passages, group)
    n_groups = n_padded // group
    k_eff = min(k, n)
    s3 = scores.view(qn, n_groups, group)
    top_s, top_i = select_from_groupmax(s3, gmax, k_eff, group, valid)
    if k_eff < k:
        top_s = F.pad(top_s, (0, k - k_eff), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - k_eff), value=-1)
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_s, top_i
