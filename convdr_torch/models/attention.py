"""Attention with segment-id padding: the hand-written CUDA flash kernels
(forward and backward) and their plain PyTorch versions.

Padding is expressed through segment ids (valid tokens = segment 1, pads =
segment 0), exactly the rule of the Pallas TPU kernel the JAX package calls
(``convdr_tpu/models/attention.py::flash_attention``): valid queries never
attend to pads, pads attend only to each other, and their outputs are
excluded downstream by the pooling masks. An all-pad row is therefore finite.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (any T, head_dim 16/32/64, f32 or bf16) and takes the plain version
for CPU tensors. When autograd needs its gradient (training), it goes
through :class:`FlashAttentionFn`, whose backward launches
``csrc/flash_attention_bwd.cu`` (f32) for CUDA tensors and
:func:`flash_attention_bwd_plain` for CPU tensors. There is no other
fallback: a CUDA input the kernels do not take raises. This device test is
the whole of the JAX package's ``multi_head_attention`` dispatch here: the
TPU kernel's gate (T >= 256, T % 128 == 0) does not apply, every length
goes through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from convdr_torch.core.config import NOT_PORTED
from convdr_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def _probs_plain(q, k, attention_mask):
    """Softmax of the masked, scaled scores [B, H, Tq, Tk] in f32; query i
    sees key j iff seg[i] == seg[j]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / q.shape[-1] ** 0.5)
    seg = attention_mask.to(torch.int32)
    allowed = seg[:, None, :, None] == seg[:, None, None, :]  # [B,1,Tq,Tk]
    return torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)


def flash_attention_plain(q, k, v, attention_mask):
    """Segment-equality softmax attention in PyTorch, f32 arithmetic.

    q/k/v [B, T, H, D]; attention_mask [B, T] 0/1 -> [B, T, H, D] in q's
    dtype. Every query is allowed at least its own key, so no row is empty.
    """
    probs = _probs_plain(q, k, attention_mask)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, do, attention_mask):
    """dQ, dK, dV of :func:`flash_attention_plain`, written out in f32.

    The same formula the kernel computes, step by step (not autograd):
    P = softmax(S) under the mask, D = rowsum(dO * O), dP = dO V^T,
    dS = P * (dP - D), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
    All of [B, T, H, D]; returned in q's dtype.
    """
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    probs = _probs_plain(qf, kf, attention_mask)                    # [B,H,Tq,Tk]
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]           # [B,H,Tq,1]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = probs * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, dof)
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


def _check(name, tensors, attention_mask, dtypes):
    """Validate [B, T, H, D] CUDA operands and the [B, T] mask; -> (b, t, h, d)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(
            f"{name} wants operands of one [B, T, H, D] shape, got "
            f"{[tuple(x.shape) for x in tensors]}"
        )
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in dtypes or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(
            f"{name} takes {' or '.join(str(x)[6:] for x in dtypes)} operands "
            f"of one dtype, got {[x.dtype for x in tensors]}"
        )
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name} needs contiguous operands")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{name} needs 16-byte aligned operands")
    if tuple(attention_mask.shape) != (b, t):
        raise ValueError(f"{name}: mask {tuple(attention_mask.shape)} != {(b, t)}")
    if any(x.device != q.device for x in tensors) or attention_mask.device != q.device:
        raise ValueError(f"{name}: operands and mask must share a device")
    return b, t, h, d


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = [_PTR] * 6 + [_INT] * 4 + [_FLOAT, _INT, _PTR]
_BWD_ARGTYPES = [_PTR] * 10 + [_INT] * 4 + [_FLOAT, _PTR]


def flash_attention_fwd_config(batch, seq, heads, head_dim, dtype):
    """The forward kernel's launch configuration for a problem, as the C
    query ``convdr_flash_attention_fwd_config`` reports it: threads a
    block, dynamic shared memory bytes, query rows a block, resident blocks
    an SM and keys a tile (needs the card)."""
    fn = cuda_build.bind("flash_attention", "convdr_flash_attention_fwd_config",
                         [_INT] * 5 + [_PTR])
    out = (ctypes.c_int * 5)()
    rc = fn(batch, seq, heads, head_dim, _DTYPE_CODES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"convdr_flash_attention_fwd_config: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "block_queries", "blocks_per_sm",
                     "tile_keys"), out))


def flash_attention_bwd_config(batch, seq, heads, head_dim):
    """The backward kernel's launch configuration for an f32 problem, as the
    C query ``convdr_flash_attention_bwd_config`` reports it: threads a
    block, dynamic shared memory bytes, rows a block (keys or queries),
    resident blocks an SM and rows a streamed tile (needs the card)."""
    fn = cuda_build.bind("flash_attention_bwd", "convdr_flash_attention_bwd_config",
                         [_INT] * 4 + [_PTR])
    out = (ctypes.c_int * 5)()
    rc = fn(batch, seq, heads, head_dim, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"convdr_flash_attention_bwd_config: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "block_rows", "blocks_per_sm", "tile_rows"), out))


def flash_attention_fwd(q, k, v, attention_mask, with_lse: bool):
    """Launch the forward kernel on CUDA tensors; -> (out, lse [B, H, T] f32
    or None). ``with_lse`` (f32 only) also writes each row's log-sum-exp of
    the scaled scores, which the backward needs."""
    b, t, h, d = _check("flash_attention", (q, k, v), attention_mask,
                        tuple(_DTYPE_CODES))
    seg = attention_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), device=q.device, dtype=torch.float32)
           if with_lse else None)
    fn = cuda_build.bind("flash_attention", "convdr_flash_attention_fwd", _FWD_ARGTYPES)
    rc = cuda_build.launch(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, t, h, d, 1.0 / d ** 0.5, _DTYPE_CODES[q.dtype],
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, attention_mask, lse):
    """dQ, dK, dV [B, T, H, D] of :func:`flash_attention` at output ``o``
    with upstream gradient ``do``; ``lse`` [B, H, T] is the forward's
    per-row log-sum-exp.

    CUDA tensors go through the kernel of ``csrc/flash_attention_bwd.cu``
    (f32 only; one launch computes all three gradients and rowsum(dO * O));
    CPU tensors through :func:`flash_attention_bwd_plain` (which needs no
    ``lse``). ``flash_attention_bwd.launches`` counts kernel launches, one
    per call on the card.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, attention_mask)
    if q.dtype != torch.float32:
        raise NotImplementedError(
            f"the flash-attention backward in {q.dtype} (bf16 training) {NOT_PORTED}"
        )
    b, t, h, d = _check("flash_attention_bwd", (q, k, v, o, do), attention_mask,
                        (torch.float32,))
    if lse is None or tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd needs the forward's f32 lse [B, H, T]")
    seg = attention_mask.to(torch.int32).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = cuda_build.bind("flash_attention_bwd", "convdr_flash_attention_bwd", _BWD_ARGTYPES)
    rc = cuda_build.launch(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), seg.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, h, d, 1.0 / d ** 0.5,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on CUDA tensors, the
    plain forward and :func:`flash_attention_bwd_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, attention_mask), None
        elif q.dtype != torch.float32:
            raise NotImplementedError(
                f"training through flash attention in {q.dtype} (bf16 training) "
                f"{NOT_PORTED}"
            )
        else:
            out, lse = flash_attention_fwd(q, k, v, attention_mask, with_lse=True)
        ctx.save_for_backward(q, k, v, out, attention_mask, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, attention_mask, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, do.contiguous(), attention_mask, lse
        )
        return dq, dk, dv, None


def flash_attention(q, k, v, attention_mask):
    """[B, T, H, D] q/k/v + [B, T] 0/1 mask -> [B, T, H, D].

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`flash_attention_plain`. When autograd is recording and any of
    q/k/v needs a gradient, the call goes through :class:`FlashAttentionFn`.
    ``flash_attention.launches`` counts forward kernel launches.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, attention_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, attention_mask)
    return flash_attention_fwd(q, k, v, attention_mask, with_lse=False)[0]


flash_attention.launches = 0
