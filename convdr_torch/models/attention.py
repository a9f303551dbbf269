"""Attention with segment-id padding: the hand-written CUDA flash kernel and
its plain PyTorch version.

Padding is expressed through segment ids (valid tokens = segment 1, pads =
segment 0), exactly the rule of the Pallas TPU kernel the JAX package calls
(``convdr_tpu/models/attention.py::flash_attention``): valid queries never
attend to pads, pads attend only to each other, and their outputs are
excluded downstream by the pooling masks. An all-pad row is therefore finite.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (any T, head_dim 16/32/64, f32 or bf16) and takes the plain version
for CPU tensors. There is no other fallback: a CUDA input the kernel does
not take raises. This device test is the whole of the JAX package's
``multi_head_attention`` dispatch here: the TPU kernel's gate (T >= 256,
T % 128 == 0) does not apply, every length rung goes through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from convdr_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def flash_attention_plain(q, k, v, attention_mask):
    """Segment-equality softmax attention in PyTorch, f32 arithmetic.

    q/k/v [B, T, H, D]; attention_mask [B, T] 0/1 -> [B, T, H, D] in q's
    dtype. Every query is allowed at least its own key, so no row is empty.
    """
    head_dim = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / head_dim ** 0.5)
    seg = attention_mask.to(torch.int32)
    allowed = seg[:, None, :, None] == seg[:, None, None, :]  # [B,1,Tq,Tk]
    scores = scores.masked_fill(~allowed, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, attention_mask):
    """[B, T, H, D] q/k/v + [B, T] 0/1 mask -> [B, T, H, D].

    CUDA tensors go through the hand-written kernel; CPU tensors through
    :func:`flash_attention_plain`. ``flash_attention.launches`` counts
    kernel launches.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, attention_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention wants q/k/v of one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q/k/v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q/k/v")
    if tuple(attention_mask.shape) != (b, t):
        raise ValueError(
            f"flash_attention: mask {tuple(attention_mask.shape)} != {(b, t)}"
        )
    if k.device != q.device or v.device != q.device or attention_mask.device != q.device:
        raise ValueError("flash_attention: q, k, v and mask must share a device")
    seg = attention_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = cuda_build.load("flash_attention")
    fn = lib.convdr_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), b, t, h, d, 1.0 / d ** 0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

