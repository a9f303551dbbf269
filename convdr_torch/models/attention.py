"""Attention with segment-id padding: the hand-written CUDA flash kernels
(forward and backward) and their plain PyTorch versions.

Padding is expressed through segment ids (valid tokens = segment 1, pads =
segment 0), exactly the rule of the Pallas TPU kernel the JAX package calls
(``convdr_tpu/models/attention.py::flash_attention``): valid queries never
attend to pads, pads attend only to each other, and their outputs are
excluded downstream by the pooling masks. An all-pad row is therefore finite.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (any T, head_dim 16/32/64, f32 or bf16) and takes the plain version
for CPU tensors. When autograd needs its gradient (training, f32 or bf16),
it goes through :class:`FlashAttentionFn`: the forward also writes each
row's f32 log-sum-exp, and the backward launches
``csrc/flash_attention_bwd.cu`` (on the tensor cores: f32 as six-part bf16
products, bf16 with the Pallas backward's roundings) for CUDA tensors and
:func:`flash_attention_bwd_plain` for CPU tensors. There is no other
fallback: a CUDA input the kernels do not take raises. This device test is
the whole of the JAX package's ``multi_head_attention`` dispatch here: the
TPU kernel's gate (T >= 256, T % 128 == 0) does not apply, every length
goes through the kernels. Training with attention dropout takes
:func:`dropout_attention_plain` instead, as the JAX package takes its
plain einsum there.

:func:`causal_attention` is a decoder's attention (DeepSeek-V2's latent
attention, used as an encoder): a causal mask beside the segment rule,
query/key head dim 192 and value head dim 128, an explicit softmax scale;
bf16 CUDA tensors launch the kernel's causal variant, CPU tensors take
:func:`causal_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from convdr_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 if it is narrower (bf16), else as it is: f64 stays f64,
    so the plain path can run a whole step in f64 as an exact witness."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _probs_plain(q, k, attention_mask):
    """Softmax of the masked, scaled scores [B, H, Tq, Tk] in f32 (f64 for
    f64 operands); query i sees key j iff seg[i] == seg[j]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", at_least_f32(q), at_least_f32(k))
    scores = scores * (1.0 / q.shape[-1] ** 0.5)
    seg = attention_mask.to(torch.int32)
    allowed = seg[:, None, :, None] == seg[:, None, None, :]  # [B,1,Tq,Tk]
    return torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)


def flash_attention_plain(q, k, v, attention_mask):
    """Segment-equality softmax attention in PyTorch, f32 arithmetic (f64
    for f64 operands).

    q/k/v [B, T, H, D]; attention_mask [B, T] 0/1 -> [B, T, H, D] in q's
    dtype. Every query is allowed at least its own key, so no row is empty.
    """
    probs = _probs_plain(q, k, attention_mask)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, at_least_f32(v))
    return out.to(q.dtype)


def dropout_attention_plain(q, k, v, attention_mask, dropout):
    """Attention under active attention dropout, as the JAX package's
    student computes it there (``convdr_tpu/models/transformer.py:50-75``):
    the plain softmax, cast to q's dtype, through ``dropout`` (a module or
    function), then P V in f32 arithmetic (f64 for f64 operands) and the
    result in q's dtype. With an identity ``dropout`` and f32 operands it
    is :func:`flash_attention_plain` bit for bit."""
    probs = dropout(_probs_plain(q, k, attention_mask).to(q.dtype))
    out = torch.einsum("bhqk,bkhd->bqhd", at_least_f32(probs), at_least_f32(v))
    return out.to(q.dtype)


def flash_attention_bwd_plain(q, k, v, o, do, attention_mask):
    """dQ, dK, dV of :func:`flash_attention_plain`, written out in f32
    (f64 for an f64 q).

    The kernel's formula, step by step (not autograd): P = softmax(S) under
    the mask, dP = dO V^T, D = rowsum(P * dP), dS = P * (dP - D),
    dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. All of [B, T, H, D];
    returned in q's dtype. The kernels take D = rowsum(dO * O), equal in
    exact arithmetic; here D comes from the unrounded P V (``o`` is taken
    for the kernel's call shape and not read), so on bf16
    operands, where O is rounded, this stays the exact gradient of
    :func:`flash_attention_plain` (the yardstick of the bf16 kernel, which
    rounds O, P and dS to bf16 where the Pallas backward does).
    """
    scale = 1.0 / q.shape[-1] ** 0.5
    wide = at_least_f32(q).dtype
    qf, kf, vf, dof = (x.to(wide) for x in (q, k, v, do))
    probs = _probs_plain(qf, kf, attention_mask)                    # [B,H,Tq,Tk]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (probs * dp).sum(-1, keepdim=True)                      # [B,H,Tq,1]
    ds = probs * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, dof)
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


def _check(name, tensors, attention_mask, dtypes):
    """Validate [B, T, H, D] CUDA operands and the [B, T] mask (if given);
    -> (b, t, h, d)."""
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
    if attention_mask is not None and tuple(attention_mask.shape) != (b, t):
        raise ValueError(f"{name}: mask {tuple(attention_mask.shape)} != {(b, t)}")
    if any(x.device != q.device for x in tensors) or (
            attention_mask is not None and attention_mask.device != q.device):
        raise ValueError(f"{name}: operands and mask must share a device")
    return b, t, h, d


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = [_PTR] * 6 + [_INT] * 4 + [_FLOAT, _INT, _PTR]
_BWD_ARGTYPES = [_PTR] * 11 + [_INT] * 4 + [_FLOAT, _INT, _PTR]
_DELTA_ARGTYPES = [_PTR] * 3 + [_INT] * 5 + [_PTR]


FWD_PATHS = ("bf16 wgmma", "f32 six-part wgmma", "f32 six-part wgmma small grid")


def flash_attention_fwd_config(batch, seq, heads, head_dim, dtype):
    """The forward kernel's launch configuration for a problem, as the C
    query ``convdr_flash_attention_fwd_config`` reports it: threads a
    block, dynamic shared memory bytes, query rows a block, resident blocks
    an SM, keys a tile and the path (one of ``FWD_PATHS``: f32 takes the
    small-grid path, blocks of 64 query rows, while the grid of 128-row
    blocks, ceil(T / 128) * H * B, is at most the kernel source's
    ``kSmallGridBlocks``, and 128-row blocks above; needs the card)."""
    fn = cuda_build.bind("flash_attention", "convdr_flash_attention_fwd_config",
                         [_INT] * 5 + [_PTR])
    out = (ctypes.c_int * 6)()
    rc = fn(batch, seq, heads, head_dim, _DTYPE_CODES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"convdr_flash_attention_fwd_config: CUDA error {rc}")
    cfg = dict(zip(("threads", "smem_bytes", "block_queries", "blocks_per_sm",
                    "tile_keys"), out))
    cfg["path"] = FWD_PATHS[out[5]]
    return cfg


def flash_attention_bwd_config(batch, seq, heads, head_dim, dtype=torch.float32):
    """The backward kernel's launch configuration for a problem (f32 or
    bf16), as the C query ``convdr_flash_attention_bwd_config`` reports it:
    threads a block, dynamic shared memory bytes, rows a block (keys or
    queries), resident blocks an SM and rows a streamed tile (needs the
    card). f32: one warpgroup of 128 threads, 64 rows, 32-row tiles, two
    blocks an SM; bf16: a warpgroup and a producer warp, three an SM."""
    fn = cuda_build.bind("flash_attention_bwd", "convdr_flash_attention_bwd_config",
                         [_INT] * 5 + [_PTR])
    out = (ctypes.c_int * 5)()
    rc = fn(batch, seq, heads, head_dim, _DTYPE_CODES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"convdr_flash_attention_bwd_config: CUDA error {rc}")
    return dict(zip(("threads", "smem_bytes", "block_rows", "blocks_per_sm", "tile_rows"), out))


def flash_attention_fwd(q, k, v, attention_mask, with_lse: bool):
    """Launch the forward kernel on CUDA tensors; -> (out, lse [B, H, T] f32
    or None). ``with_lse`` also writes each row's log-sum-exp of the scaled
    scores, which the backward needs; ``out`` is the same either way. f32
    runs on the tensor cores as six bf16 ``wgmma`` products of the
    operands' exact bf16 parts, in blocks of 128 query rows (two
    warpgroups sharing each key tile's split) or, for small grids such as
    the serving encode's B=1, of 64; a row's out and lse are the same bit
    for bit in either."""
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

    CUDA tensors go through the kernels of ``csrc/flash_attention_bwd.cu``
    in one C call: a pre-pass writes D = rowsum(dO * O) in f32 into a
    [B, H, T] scratch made here, then one launch computes the three
    gradients on the tensor cores, recomputing P from ``lse``. f32 runs six
    bf16 ``wgmma`` products of the operands' exact bf16 parts for each of
    S, dP, dV, dK and dQ (S in the forward's products and order, so bit for
    bit the scores the forward's lse was taken over; each tile's share of a
    gradient added into an IEEE f32 sum); its bound is those products'
    60HD operations a pair in segment at the bf16 peak. bf16, with bf16
    gradients, rounds P and dS to bf16 where the Pallas backward does.
    CPU tensors go through :func:`flash_attention_bwd_plain` (which needs
    no ``lse``). ``flash_attention_bwd.launches`` counts calls that
    launched on the card, one per call.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, attention_mask)
    b, t, h, d = _check("flash_attention_bwd", (q, k, v, o, do), attention_mask,
                        tuple(_DTYPE_CODES))
    if lse is None or tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd needs the forward's f32 lse [B, H, T]")
    seg = attention_mask.to(torch.int32).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    fn = cuda_build.bind("flash_attention_bwd", "convdr_flash_attention_bwd", _BWD_ARGTYPES)
    rc = cuda_build.launch(
        fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), seg.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), b, t, h, d, 1.0 / d ** 0.5,
        _DTYPE_CODES[q.dtype],
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_delta(o, do):
    """The backward's pre-pass alone on CUDA tensors: rowsum(o * do) in f32
    of f32 or bf16 [B, T, H, D] ``o`` and ``do``, as [B, H, T] (the D that
    :func:`flash_attention_bwd` computes once a call)."""
    b, t, h, d = _check("flash_attention_bwd_delta", (o, do), None, tuple(_DTYPE_CODES))
    delta = torch.empty((b, h, t), device=o.device, dtype=torch.float32)
    fn = cuda_build.bind("flash_attention_bwd", "convdr_flash_attention_bwd_delta",
                         _DELTA_ARGTYPES)
    rc = cuda_build.launch(fn, o.device, o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                           b, t, h, d, _DTYPE_CODES[o.dtype])
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_delta launch failed: CUDA error {rc}")
    return delta


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on CUDA tensors, the
    plain forward and :func:`flash_attention_bwd_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, attention_mask), None
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


CAUSAL_DIMS = (192, 128)  # (query/key, value) head dims of the causal kernel
_CAUSAL_ARGTYPES = [_PTR] * 5 + [_INT] * 5 + [_FLOAT, _PTR]


def causal_attention_plain(q, k, v, attention_mask, scale: float):
    """Causal segment-equality softmax attention in PyTorch, f32
    arithmetic (f64 for f64 operands): query t sees key s iff s <= t and
    their segments (the 0/1 mask) are equal, so a right-padded pad sees
    the pads up to itself and no row is empty.

    q, k [B, T, H, Dqk], v [B, T, H, Dv], attention_mask [B, T] ->
    [B, T, H, Dv] in q's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", at_least_f32(q), at_least_f32(k)) * scale
    seg = attention_mask.to(torch.int32)
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    allowed = (seg[:, None, :, None] == seg[:, None, None, :]) & (pos[None, None, None, :]
                                                                  <= pos[None, None, :, None])
    probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, at_least_f32(v)).to(q.dtype)


def causal_attention_fwd(q, k, v, attention_mask, scale: float):
    """Launch kernel 1's causal variant (``csrc/flash_attention.cu``) on
    bf16 CUDA tensors q, k [B, T, H, 192] and v [B, T, H, 128]."""
    b, t, h, dqk = q.shape
    dv = v.shape[-1]
    if (dqk, dv) != CAUSAL_DIMS or tuple(k.shape) != (b, t, h, dqk) or \
            tuple(v.shape[:3]) != (b, t, h):
        raise ValueError(f"causal_attention takes q, k [B, T, H, {CAUSAL_DIMS[0]}] and v "
                         f"[B, T, H, {CAUSAL_DIMS[1]}], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError("causal_attention's kernel takes bf16 operands")
    if not all(x.is_contiguous() for x in (q, k, v)) or any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("causal_attention needs contiguous 16-byte aligned operands")
    seg = attention_mask.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, dv), device=q.device, dtype=q.dtype)
    fn = cuda_build.bind("flash_attention", "convdr_flash_attention_causal_fwd",
                         _CAUSAL_ARGTYPES)
    rc = cuda_build.launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           seg.data_ptr(), out.data_ptr(), b, t, h, dqk, dv, float(scale))
    if rc != 0:
        raise RuntimeError(f"causal attention kernel launch failed: CUDA error {rc}")
    causal_attention.launches += 1
    return out


def causal_attention(q, k, v, attention_mask, scale: float):
    """q, k [B, T, H, Dqk], v [B, T, H, Dv] + [B, T] 0/1 mask -> [B, T, H,
    Dv]: CUDA tensors through the kernel's causal variant (inference only,
    (192, 128) head dims, bf16), CPU tensors through
    :func:`causal_attention_plain`. ``causal_attention.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, attention_mask, scale)
    return causal_attention_fwd(q, k, v, attention_mask, scale)


causal_attention.launches = 0
