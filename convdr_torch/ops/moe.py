"""A routed expert layer's device work: the router, the ordering of the
routed rows by expert, the grouped SwiGLU products over the experts held,
and the weighted combine.

Per layer, with x [N, H] the valid tokens' rows (pads take no expert
capacity: the caller packs them out):

  * :func:`route`: the router's logits in f32, ``softmax(x W_g^T)``, and
    each token's top-k experts with their probabilities (greedy, not
    renormalised, times the routed scaling factor);
  * :func:`order_by_expert`: the ``N * k`` routed rows sorted by expert
    (stable, so a token's rows keep their order within an expert), each
    expert's row offsets and each expert's tile offsets, all on the device:
    no host sync and no Python loop over experts;
  * :func:`grouped_swiglu`: ``weight * down_e(silu(gate_e x) * up_e x)``
    of every routed row under its expert, written at its slot's row. CUDA
    tensors launch two Triton kernels (``_swiglu_gate_up``, which gathers
    its rows' tokens and writes the activation in the compute dtype, in
    sorted order, then ``_swiglu_down``, which scales each row by its
    routing weight and stores it at its slot);
    their grid is the bound ``ceil(N k / BM) + E`` row tiles, each tile
    finding its expert in the tile offsets, so its size needs no device
    value on the host. CPU tensors take :func:`grouped_swiglu_plain`, a
    loop over the experts with the same roundings;
  * :func:`combine`: each token's k weighted rows summed in f32.

``grouped_swiglu.launches`` counts the Triton launches (two a call).
Triton is imported, and its kernels built, at the first launch, never
when this module is imported; its cache lives in the port's build
directory (``convdr_torch/build/triton``).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

from convdr_torch.ops.cuda_build import BUILD_DIR

BLOCK_M = 128  # routed rows a tile of the grouped kernels


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
          scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probabilities [N, k] f32, experts [N, k] int64) of each token's
    top-k experts under the softmax router, its logits taken in f32."""
    logits = F.linear(x.float(), gate_weight.float())
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    return weights * scaling, experts


def order_by_expert(experts: torch.Tensor, n_experts: int, block_m: int = BLOCK_M):
    """The routed rows sorted by expert: (slots [N k] int64, each sorted
    row's slot ``token * k + j``; counts [E] int64; row_offsets [E + 1]
    int32; tile_offsets [E + 1] int32, the first ``block_m``-row tile of
    each expert), all computed on the device."""
    flat = experts.reshape(-1)
    slots = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    zero = counts.new_zeros(1)
    row_offsets = torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)
    tiles = (counts + block_m - 1) // block_m
    tile_offsets = torch.cat([zero, torch.cumsum(tiles, 0)]).to(torch.int32)
    return slots, counts, row_offsets, tile_offsets


def grouped_swiglu_plain(x, slots, row_offsets, weights, w_gate, w_up, w_down):
    """The grouped product as a loop over the experts (CPU tensors): for
    expert e's sorted rows ``[row_offsets[e], row_offsets[e + 1])``, whose
    slots ``slots`` give their tokens (``slot // k``) and weights,
    ``silu(x w_gate[e]^T) * (x w_up[e]^T)`` in f32 (f64 for f64 operands),
    rounded to x's dtype, then ``down`` times the slot's weight, rounded to
    x's dtype at the slot's row: the kernels' roundings. -> [N k, H]."""
    wide = torch.promote_types(x.dtype, torch.float32)
    k = weights.shape[1]
    flat_w = weights.reshape(-1).to(wide)
    out = x.new_empty((slots.shape[0], w_down.shape[1]))
    bounds = row_offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        rows = slots[lo:hi]
        xe = x[rows // k].to(wide)
        act = F.silu(xe @ w_gate[e].to(wide).T) * (xe @ w_up[e].to(wide).T)
        y = act.to(x.dtype).to(wide) @ w_down[e].to(wide).T
        out[rows] = (y * flat_w[rows, None]).to(x.dtype)
    return out


_KERNELS = {}


def _kernels():
    """The two Triton kernels, built at first use."""
    if _KERNELS:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def _swiglu_gate_up(x_ptr, slot_ptr, wg_ptr, wu_ptr, act_ptr, row_off_ptr, tile_off_ptr,
                        n_experts, H: tl.constexpr, I: tl.constexpr, K: tl.constexpr,
                        EP: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr,
                        BK: tl.constexpr):
        # the expert of row tile program_id(0): the experts whose tiles end at
        # or before it; its rows [start, end) of the sorted rows
        pid = tl.program_id(0)
        e_idx = tl.arange(0, EP)
        ends = tl.load(tile_off_ptr + 1 + e_idx, mask=e_idx < n_experts, other=2 ** 30)
        e = tl.sum((ends <= pid).to(tl.int32), axis=0)
        e_safe = tl.minimum(e, n_experts - 1)
        start = tl.load(row_off_ptr + e_safe) + (pid - tl.load(tile_off_ptr + e_safe)) * BM
        end = tl.load(row_off_ptr + e_safe + 1)
        if e < n_experts:
            rows = start + tl.arange(0, BM)
            live = rows < end
            tok = (tl.load(slot_ptr + rows, mask=live, other=0) // K).to(tl.int64)
            cols = tl.program_id(1) * BN + tl.arange(0, BN)
            col_ok = cols < I
            ks = tl.arange(0, BK)
            w_base = e_safe.to(tl.int64) * I * H
            acc_g = tl.zeros((BM, BN), dtype=tl.float32)
            acc_u = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, H, BK):
                k_ok = k0 + ks < H
                a = tl.load(x_ptr + tok[:, None] * H + (k0 + ks)[None, :],
                            mask=live[:, None] & k_ok[None, :], other=0.0)
                w_off = w_base + cols[None, :].to(tl.int64) * H + (k0 + ks)[:, None]
                w_ok = k_ok[:, None] & col_ok[None, :]
                acc_g = tl.dot(a, tl.load(wg_ptr + w_off, mask=w_ok, other=0.0), acc_g)
                acc_u = tl.dot(a, tl.load(wu_ptr + w_off, mask=w_ok, other=0.0), acc_u)
            act = acc_g / (1.0 + tl.exp(-acc_g)) * acc_u
            dst = act_ptr + rows[:, None].to(tl.int64) * I + cols[None, :]
            tl.store(dst, act.to(act_ptr.dtype.element_ty), mask=live[:, None] & col_ok[None, :])

    @triton.jit
    def _swiglu_down(act_ptr, wd_ptr, slot_ptr, w_ptr, y_ptr, row_off_ptr, tile_off_ptr,
                     n_experts, H: tl.constexpr, I: tl.constexpr, EP: tl.constexpr,
                     BM: tl.constexpr, BN: tl.constexpr, BK: tl.constexpr):
        # the expert of row tile program_id(0): the experts whose tiles end at
        # or before it; its rows [start, end) of the sorted rows
        pid = tl.program_id(0)
        e_idx = tl.arange(0, EP)
        ends = tl.load(tile_off_ptr + 1 + e_idx, mask=e_idx < n_experts, other=2 ** 30)
        e = tl.sum((ends <= pid).to(tl.int32), axis=0)
        e_safe = tl.minimum(e, n_experts - 1)
        start = tl.load(row_off_ptr + e_safe) + (pid - tl.load(tile_off_ptr + e_safe)) * BM
        end = tl.load(row_off_ptr + e_safe + 1)
        if e < n_experts:
            rows = start + tl.arange(0, BM)
            live = rows < end
            cols = tl.program_id(1) * BN + tl.arange(0, BN)
            col_ok = cols < H
            ks = tl.arange(0, BK)
            w_base = e_safe.to(tl.int64) * H * I
            acc = tl.zeros((BM, BN), dtype=tl.float32)
            for k0 in range(0, I, BK):
                k_ok = k0 + ks < I
                a = tl.load(act_ptr + rows[:, None].to(tl.int64) * I + (k0 + ks)[None, :],
                            mask=live[:, None] & k_ok[None, :], other=0.0)
                w = tl.load(wd_ptr + w_base + cols[None, :].to(tl.int64) * I + (k0 + ks)[:, None],
                            mask=k_ok[:, None] & col_ok[None, :], other=0.0)
                acc = tl.dot(a, w, acc)
            # the slot's weight, and its row of the output
            slot = tl.load(slot_ptr + rows, mask=live, other=0)
            acc = acc * tl.load(w_ptr + slot, mask=live, other=0.0)[:, None]
            dst = y_ptr + slot[:, None].to(tl.int64) * H + cols[None, :]
            tl.store(dst, acc.to(y_ptr.dtype.element_ty), mask=live[:, None] & col_ok[None, :])

    _KERNELS.update(triton=triton, gate_up=_swiglu_gate_up, down=_swiglu_down)
    return _KERNELS


# tiles of the two kernels: (BM rows, BN columns, BK depth, warps, stages),
# the fastest of a sweep on the card at 100,000 tokens, 64 experts, top-6
GATE_UP_TILE = (BLOCK_M, 128, 64, 8, 4)
DOWN_TILE = (BLOCK_M, 256, 64, 8, 3)


def grouped_swiglu_cuda(x, slots, row_offsets, tile_offsets, weights, w_gate, w_up, w_down):
    """The grouped product's two Triton launches on CUDA tensors (bf16)."""
    kern = _kernels()
    triton = kern["triton"]
    n_experts, inter, hidden = w_gate.shape
    rows = slots.shape[0]
    ep = triton.next_power_of_2(n_experts + 1)
    tiles = triton.cdiv(rows, BLOCK_M) + n_experts  # at least the experts' tiles
    act = x.new_empty((rows, inter))
    y = x.new_empty((rows, hidden))
    slot = slots.to(torch.int32)
    bm, bn, bk, warps, stages = GATE_UP_TILE
    kern["gate_up"][(tiles, triton.cdiv(inter, bn))](
        x, slot, w_gate, w_up, act, row_offsets, tile_offsets, n_experts, H=hidden, I=inter,
        K=weights.shape[1], EP=ep, BM=bm, BN=bn, BK=bk, num_warps=warps, num_stages=stages)
    bm, bn, bk, warps, stages = DOWN_TILE
    kern["down"][(tiles, triton.cdiv(hidden, bn))](
        act, w_down, slot, weights.reshape(-1).float().contiguous(), y, row_offsets,
        tile_offsets, n_experts, H=hidden, I=inter, EP=ep, BM=bm, BN=bn, BK=bk,
        num_warps=warps, num_stages=stages)
    grouped_swiglu.launches += 2
    return y


def grouped_swiglu(x, slots, row_offsets, tile_offsets, weights, w_gate, w_up, w_down):
    """``weight * down_e(silu(gate_e x) * up_e x)`` of each routed row, at
    its slot's row.

    x [N, H] the tokens' rows; slots [N k] the sorted rows' slots
    ``token * k + j``, row_offsets / tile_offsets [E + 1] int32, from
    :func:`order_by_expert`; weights [N, k] f32 the routing weights; w_gate,
    w_up [E, I, H] and w_down [E, H, I] in x's dtype. -> [N k, H] in x's
    dtype, row ``token * k + j`` the token's j-th expert's weighted output.
    CUDA: the Triton kernels; CPU: :func:`grouped_swiglu_plain`."""
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, slots, row_offsets, weights, w_gate, w_up, w_down)
    return grouped_swiglu_cuda(x, slots, row_offsets, tile_offsets, weights,
                               w_gate.contiguous(), w_up.contiguous(), w_down.contiguous())


grouped_swiglu.launches = 0


def combine(y: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's sum of its k weighted rows of ``y`` [N k, H], in f32
    (f64 for f64 rows) -> [N, H]."""
    wide = torch.promote_types(y.dtype, torch.float32)
    return torch.sum(y.view(-1, top_k, y.shape[1]), dim=1, dtype=wide)
