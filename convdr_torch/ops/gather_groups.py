"""Candidate group gather out of a score block: the hand-written CUDA
kernel and its plain PyTorch version.

The counterpart of ``dma_gather_groups`` in
``convdr_tpu/ops/pallas_search.py`` (lines 234-346), there the opt-in
``gather="dma"``; here the candidate gather of every exact search on the
card (:func:`convdr_torch.ops.exact_search.select_from_groupmax`). The TPU
kernel's tiling constraints (Q % 8, B % 128, G dividing 128) came from
Mosaic's (8, 128) tiles and are not part of the function: the port takes
any Q, any G that divides B, int32 or int64 ids, and keeps the one real
check, f32 scores.
"""

from __future__ import annotations

import ctypes

import torch

from convdr_torch.ops import cuda_build

_IDX_BYTES = {torch.int32: 4, torch.int64: 8}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(scores: torch.Tensor, gsel: torch.Tensor, group: int) -> None:
    if scores.dtype != torch.float32:
        raise ValueError("scores must be f32 (the search score dtype)")
    if scores.dim() != 2 or gsel.dim() != 2 or gsel.shape[0] != scores.shape[0]:
        raise ValueError(
            f"dma_gather_groups wants scores [Q, B] and gsel [Q, K], got "
            f"{tuple(scores.shape)} and {tuple(gsel.shape)}"
        )
    if group <= 0 or scores.shape[1] % group:
        raise ValueError(f"columns {scores.shape[1]} not a multiple of group {group}")
    if gsel.dtype not in _IDX_BYTES:
        raise ValueError(f"gsel must be int32 or int64, got {gsel.dtype}")


def dma_gather_groups_plain(
    scores: torch.Tensor, gsel: torch.Tensor, *, group: int = 32
) -> torch.Tensor:
    """out[q, j, :] = scores[q, g*group:(g+1)*group] for g = gsel[q, j],
    [Q, K, group] f32, as a ``torch.gather`` over the group axis."""
    _check(scores, gsel, group)
    qn, b = scores.shape
    s3 = scores.view(qn, b // group, group)
    return torch.gather(s3, 1, gsel.long()[:, :, None].expand(-1, -1, group))


def dma_gather_groups(
    scores: torch.Tensor, gsel: torch.Tensor, *, group: int = 32
) -> torch.Tensor:
    """[Q, K, group] f32 candidate groups of a [Q, B] f32 score block.

    CUDA tensors go through ``csrc/gather_groups.cu`` (16-byte copies; a
    ``scores`` view that is not 16-byte aligned takes its scalar path);
    CPU tensors through :func:`dma_gather_groups_plain`. Group ids must lie
    in [0, B / group) (the kernel writes NaN for one that does not).
    ``dma_gather_groups.launches`` counts kernel launches.
    """
    _check(scores, gsel, group)
    if scores.device.type == "cpu":
        return dma_gather_groups_plain(scores, gsel, group=group)
    if scores.device.type != "cuda" or gsel.device != scores.device:
        raise ValueError(
            f"dma_gather_groups: scores on {scores.device}, gsel on "
            f"{gsel.device}; both must be on one CUDA device"
        )
    qn, b = scores.shape
    k = gsel.shape[1]
    out = torch.empty((qn, k, group), dtype=torch.float32, device=scores.device)
    if out.numel() == 0:
        return out
    sc = scores if scores.is_contiguous() else scores.contiguous()
    ids = gsel if gsel.is_contiguous() else gsel.contiguous()
    fn = cuda_build.bind("gather_groups", "convdr_gather_groups", _ARGTYPES)
    rc = cuda_build.launch(
        fn, scores.device, sc.data_ptr(), ids.data_ptr(), out.data_ptr(), qn, b, k,
        group, _IDX_BYTES[ids.dtype],
    )
    if rc != 0:
        raise RuntimeError(f"dma_gather_groups kernel launch failed: CUDA error {rc}")
    dma_gather_groups.launches += 1
    return out


dma_gather_groups.launches = 0
