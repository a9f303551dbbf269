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
the product on Hopper's int8 tensor cores (``wgmma`` s8 x s8 -> s32 over a
TMA-fed ring, a persistent grid; integer sums, so equal to the plain
version whatever their order). bf16 passages take the queries as their
three bf16 parts (:func:`bf16_query_parts`: q = q1 + q2 + q3 exactly) and
the product runs on the bf16 tensor cores at every Q: three ``wgmma``
products into one f32 accumulator, the counterpart of the JAX kernel's
``Precision.HIGHEST`` on f32 x bf16 (a split-precision product of bf16
MXU passes). f32 passages split too, in the kernel, from the f32 rows as
stored (:func:`bf16_query_parts`' arithmetic), and a score is the six
bf16 ``wgmma`` products of parts whose sum is above 2^-20 of |q p| (the
MXU's HIGHEST on f32 x f32: six passes), the largest in one f32 sum and
the five small ones in another, added at the end; within 2 D 2^-24 sum
|q_k p_k| of the exact product and 1e-5 |q| max|p| of the plain f32 one.
The streaming passes issue the same arithmetic as this kernel, so their
outputs equal these bit for bit, and so do its small-Q tiles (up to 64
queries; the serving search is Q=1).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import NEG_INF, rounded_scores, select_from_groupmax
from convdr_torch.ops.quant import INT8_EXACT_MAX_DIM

# Passage rows per kernel tile; the kernel takes N % ROW_TILE == 0 and the
# callers pad rows to it (padded rows are masked through ``valid_rows``).
ROW_TILE = 128
GROUPS = (8, 16, 32, 64, 128)
_P_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# elements of 16 bytes: the kernel copies rows in 16-byte chunks
_CHUNK = {torch.float32: 4, torch.bfloat16: 8, torch.int8: 16}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# an f32's sign, exponent and 7 high significand bits: the bf16 it cuts to
_BF16_HIGH_BITS = -65536  # 0xFFFF0000 as an int32
# The largest Q whose bf16 and f32 kernels take the f32 queries and split
# them themselves (``kBfSmallQMax``, ``kF32SplitQMax`` in
# ``csrc/scores_groupmax.cu``); above it the wrapper passes
# :func:`bf16_query_parts`.
BF16_SMALL_Q_MAX = 64
F32_SPLIT_Q_MAX = 16


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


def bf16_query_parts(queries: torch.Tensor) -> torch.Tensor:
    """The three bf16 parts [3, Q, D] of f32 queries [Q, D]: q1 is q cut
    to bf16 (its low 16 bits cleared), q2 the remainder cut likewise, q3
    what is left, so that q1 + q2 + q3 == q exactly for every finite q
    with |q| >= 2^-110 or q == 0 (8 bits of significand a part cover f32's
    24; below that the last part's low bits fall under bf16's subnormals).
    Each part times a bf16 passage is exact in f32: the bf16 kernels sum
    the three products on the tensor cores. Cutting, not rounding, keeps
    q1 finite at f32's largest values."""
    q = queries.to(torch.float32).contiguous()
    q1 = (q.view(torch.int32) & _BF16_HIGH_BITS).view(torch.float32)
    rest = q - q1  # exact: the low 16 bits of q's significand
    q2 = (rest.view(torch.int32) & _BF16_HIGH_BITS).view(torch.float32)
    return torch.stack((q1, q2, rest - q2)).to(torch.bfloat16)


def kernel_operands(
    queries: torch.Tensor, passages: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, p) as ``csrc/scores_groupmax.cu`` takes them: contiguous and
    16-byte aligned, D zero-padded to 16 bytes of the passage dtype (a
    copy of the passages only where D is not: zeros after the last k leave
    every score as it was). q is f32 for f32 and bf16 passages at Q <=
    :data:`F32_SPLIT_Q_MAX` / :data:`BF16_SMALL_Q_MAX` (the kernel splits
    them); above it the [3, Q, D] bf16 parts of :func:`bf16_query_parts`,
    with f32 passages of the queries zero-padded to a multiple of 8 (the
    parts' rows in 16-byte chunks); for int8 passages int8, the
    int-valued queries of ``quantize_queries``, exact in [-127, 127] (other
    values are cut toward zero)."""
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
    q = queries.to(torch.float32)
    if pad:  # (a pad of 0 would copy: one more launch a search)
        q = F.pad(q, (0, pad))
    if passages.dtype == torch.int8:
        q = q.to(torch.int8)
    elif passages.dtype == torch.bfloat16 and q.shape[0] > BF16_SMALL_Q_MAX:
        q = bf16_query_parts(q)
    elif passages.dtype == torch.float32 and q.shape[0] > F32_SPLIT_Q_MAX:
        q = bf16_query_parts(F.pad(q, (0, (-q.shape[1]) % 8)))
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
    :data:`GROUPS`; the kernel picks its path by Q and the passage dtype,
    and any failed launch raises; f32 and bf16 scores are the six-
    and three-part tensor-core products, within 2 D 2^-24 sum |q_k p_k| of
    the exact one);
    CPU tensors through :func:`fused_scores_groupmax_plain`.
    ``fused_scores_groupmax.launches`` counts kernel launches.
    """
    if passages.device.type == "cpu":
        return fused_scores_groupmax_plain(queries, passages, group)
    check_score_operands("fused_scores_groupmax", queries, passages, group)
    q, p = kernel_operands(queries, passages)
    qn = q.shape[-2]  # above the small-Q limit: the queries' parts [3, Q, D]
    n, d = p.shape
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
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FlatIP top-k of one passage block through the fused kernel.

    Same contract as :func:`convdr_torch.ops.exact_search.flat_ip_topk`
    (score desc, lower index first on ties; slots past the valid rows hold
    (NEG_INF, -1)). Rows are zero-padded to :data:`ROW_TILE` when needed
    and masked through ``valid_rows``. ``gather`` is checked and selects
    no code (:func:`~convdr_torch.ops.exact_search.select_from_groupmax`).
    ``precision`` "high" / "default" on float passages on the card takes
    :func:`~convdr_torch.ops.exact_search.rounded_scores` and its group
    maxima in place of the kernel; the selection after it is the same.
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
    n_groups = n_padded // group
    if (precision != "highest" and passages.device.type == "cuda"
            and passages.dtype != torch.int8):
        scores = rounded_scores(queries, passages, precision)
        gmax = scores.view(qn, n_groups, group).amax(dim=-1)
    else:
        scores, gmax = fused_scores_groupmax(queries, passages, group)
    k_eff = min(k, n)
    s3 = scores.view(qn, n_groups, group)
    top_s, top_i = select_from_groupmax(s3, gmax, k_eff, group, valid, gather=gather)
    if k_eff < k:
        top_s = F.pad(top_s, (0, k - k_eff), value=NEG_INF)
        top_i = F.pad(top_i, (0, k - k_eff), value=-1)
    top_i = torch.where(top_s == NEG_INF, torch.full_like(top_i, -1), top_i)
    return top_s, top_i
