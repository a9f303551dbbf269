"""Inner-product scores with a fused group-max epilogue: the hand-written
CUDA kernel, its plain PyTorch version, and the single-shot top-k on it.

The counterpart of ``convdr_tpu/ops/pallas_search.py`` lines 93-228
(``fused_scores_groupmax`` and ``pallas_flat_ip_topk``). On the card this is
the score stage of the port's exact search (:func:`convdr_torch.ops.
exact_search.flat_ip_topk`): the kernel writes the [Q, N] f32 scores and the
[Q, N/G] group maxima in one pass, and the candidate selection stays in
PyTorch (:func:`~convdr_torch.ops.exact_search.select_from_groupmax`), as the
JAX kernel leaves it to XLA. G = 32 is the group of the JAX package's XLA
search path (``exact_search._chunked_topk``). int8 passages (SQ8 storage,
:mod:`convdr_torch.ops.quant`) take the int-valued f32 queries of
``quantize_queries``; their scores are then exact integers, equal to
``int8_topk_oracle``'s. On the card the kernel takes them as int8 and runs
the product on the int8 tensor cores.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import NEG_INF, select_from_groupmax
from convdr_torch.ops.quant import INT8_EXACT_MAX_DIM

# Passage rows per kernel tile; the kernel takes N % ROW_TILE == 0 and the
# callers pad rows to it (padded rows are masked through ``valid_rows``).
ROW_TILE = 128
GROUPS = (8, 16, 32, 64, 128)
_P_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# elements of 16 bytes: the kernel copies rows in 16-byte chunks
_CHUNK = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_score_operands(
    name: str, queries: torch.Tensor, passages: torch.Tensor, group: int
) -> None:
    """Raise unless the score kernels take these operands: [Q, D] queries
    and contiguous [N, D] f32/bf16/int8 passages on one CUDA device, N a
    multiple of :data:`ROW_TILE`, ``group`` in :data:`GROUPS`."""
    if passages.device.type != "cuda" or queries.device != passages.device:
        raise ValueError(
            f"{name}: queries on {queries.device}, passages on "
            f"{passages.device}; both must be on one CUDA device"
        )
    if queries.dim() != 2 or passages.dim() != 2:
        raise ValueError(f"{name} wants [Q, D] and [N, D]")
    if passages.shape[1] != queries.shape[1]:
        raise ValueError(
            f"dims differ: queries {queries.shape[1]}, passages {passages.shape[1]}"
        )
    if passages.shape[0] % ROW_TILE:
        raise ValueError(f"rows {passages.shape[0]} not a multiple of the tile {ROW_TILE}")
    if group not in GROUPS:
        raise ValueError(f"group {group} not in {GROUPS}")
    if passages.dtype not in _P_DTYPE_CODES:
        raise ValueError(f"passages must be f32, bf16 or int8, got {passages.dtype}")
    if not passages.is_contiguous():
        raise ValueError(f"{name} needs contiguous passages")


def kernel_operands(
    queries: torch.Tensor, passages: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, p) as ``csrc/scores_groupmax.cu`` takes them: contiguous and
    16-byte aligned, D zero-padded to 16 bytes of the passage dtype (a
    copy of the passages only where D is not: zeros after the last k leave
    every score's FMA chain as it was). q is f32, or int8 for int8
    passages: the int-valued queries of ``quantize_queries``, exact in
    [-127, 127] (other values are cut toward zero)."""
    d = passages.shape[1]
    if passages.dtype == torch.int8 and d > INT8_EXACT_MAX_DIM:
        raise ValueError(
            f"int8 scores are exact only at D <= {INT8_EXACT_MAX_DIM}, got {d}"
        )
    pad = (-d) % _CHUNK[passages.dtype]
    if pad:
        passages = F.pad(passages, (0, pad))
    elif passages.data_ptr() % 16:
        passages = passages.clone()
    q = F.pad(queries.to(torch.float32), (0, pad))
    if passages.dtype == torch.int8:
        q = q.to(torch.int8)
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    return q, passages


def fused_scores_groupmax_plain(
    queries: torch.Tensor, passages: torch.Tensor, group: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, N] f32, group maxima [Q, N/group] f32) in PyTorch: an
    f32 matmul of f32 queries and f32-upcast passages, then a max over each
    run of ``group`` columns (exact for int8 passages and int-valued
    queries: every partial sum is an integer below 2^24)."""
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

    CUDA tensors go through ``csrc/scores_groupmax.cu`` (passages f32,
    bf16 or int8, N a multiple of :data:`ROW_TILE`, ``group`` in
    :data:`GROUPS`); CPU tensors through :func:`fused_scores_groupmax_plain`.
    ``fused_scores_groupmax.launches`` counts kernel launches.
    """
    if passages.device.type == "cpu":
        return fused_scores_groupmax_plain(queries, passages, group)
    check_score_operands("fused_scores_groupmax", queries, passages, group)
    q, p = kernel_operands(queries, passages)
    qn, d = q.shape
    n = p.shape[0]
    scores = torch.empty((qn, n), dtype=torch.float32, device=passages.device)
    gmax = torch.empty((qn, n // group), dtype=torch.float32, device=passages.device)
    fn = cuda_build.bind("scores_groupmax", "convdr_scores_groupmax", _ARGTYPES)
    rc = cuda_build.launch(
        fn, passages.device, q.data_ptr(), p.data_ptr(), scores.data_ptr(),
        gmax.data_ptr(), qn, n, d, group, _P_DTYPE_CODES[passages.dtype],
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
    gather: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FlatIP top-k of one passage block through the fused kernel.

    Same contract as :func:`convdr_torch.ops.exact_search.flat_ip_topk`
    (score desc, lower index first on ties; slots past the valid rows hold
    (NEG_INF, -1)). Rows are zero-padded to :data:`ROW_TILE` when needed
    and masked through ``valid_rows``. ``gather`` is checked and selects
    no code (:func:`~convdr_torch.ops.exact_search.select_from_groupmax`).
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
    top_s, top_i = select_from_groupmax(s3, gmax, k_eff, group, valid, gather=gather)
    if k_eff < k:
        top_s = F.pad(top_s, (0, k - k_eff), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - k_eff), value=-1)
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_s, top_i
