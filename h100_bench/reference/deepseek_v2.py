"""The plain DeepSeek-V2 encoder: a RepLLaMA-style embedding of token ids
in plain PyTorch, f32.

Written from the published equations (DeepSeek-V2, arXiv:2405.04434, and
the family's ``modeling_deepseek.py``), with its Hugging Face leaf names,
and nothing of the program: pre-norm RMSNorm blocks; multi-head latent
attention with no q-LoRA (``q = W_q h``; ``[c_kv | k_pe] = W_kva h``,
``c_kv`` RMS-normed; ``[k_nope | v] = W_kvb c_kv``; k_pe shared by the
heads; the rotary half de-interleaved before rotate-half; YaRN
frequencies; causal softmax with scale ``qk_head_dim^-0.5 m^2``); a dense
SwiGLU in the first ``first_k_dense_replace`` layers, then a softmax
router over the routed experts (logits in f32, greedy top-k, not
renormalised, times ``routed_scaling_factor``) beside the shared experts;
the final RMSNorm's output at the last token, L2-normalised.

Departures, none of which changes an embedding: the output head is left
out (retrieval never reads it); each sequence is run alone at its own
length (no padding, no batch), and the per-token layers take the valid
tokens of all sequences as one list of rows; the weights are taken one
layer at a time from ``leaf(name)`` (f32 tensors of the values as
served), so 15.5 B weights need not be held in f32 at once; each routed
expert computes its tokens by an index-select. The caller turns TF32 off.
``rnd`` rounds both operands of every product (a control's lower
precision), the identity by default; ``rnd_router`` and ``rnd_experts``
round the routers' or the routed experts' products alone (a fault's).
:func:`block` computes one layer's attention or MLP block from its input
rows (with given expert choices, if any), so a check can hold each of the
program's blocks to it on the program's own inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's frequencies of the rotary half (``DeepseekV2YarnRotaryEmbedding``):
    ``freq (1 - ramp) + freq / factor * ramp`` with ramp
    ``yarn_linear_ramp_mask`` over ``yarn_find_correction_range``."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    freq_inter = freq_extra / rs["factor"]
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, d]: de-interleave (view (d / 2, 2), transpose), then
    ``x cos + rotate_half(x) sin``."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + half * sin


def attention(cfg: dict, h: torch.Tensor, w: Callable[[str], torch.Tensor], p: str,
              cos, sin, rnd=_same) -> torch.Tensor:
    """One sequence's latent attention, h [L, hidden] -> [L, hidden]."""
    n_len = h.shape[0]
    heads = cfg["num_attention_heads"]
    nope, rdim, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    q = (rnd(h) @ rnd(w(p + "q_proj.weight")).T).view(n_len, heads, nope + rdim).transpose(0, 1)
    ckv = rnd(h) @ rnd(w(p + "kv_a_proj_with_mqa.weight")).T
    c = rms_norm(ckv[:, :rank], w(p + "kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = (rnd(c) @ rnd(w(p + "kv_b_proj.weight")).T).view(n_len, heads, nope + dv).transpose(0, 1)
    k_pe = rope(ckv[:, rank:][None], cos, sin)  # [1, L, rope]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(heads, n_len, rdim)], dim=-1)
    scores = rnd(q) @ rnd(k).transpose(-1, -2) * softmax_scale(cfg)
    causal = torch.ones((n_len, n_len), dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = (rnd(probs) @ rnd(kv[..., nope:])).transpose(0, 1).reshape(n_len, heads * dv)
    return rnd(o) @ rnd(w(p + "o_proj.weight")).T


def swiglu(x: torch.Tensor, w: Callable[[str], torch.Tensor], p: str, rnd=_same):
    g = rnd(x) @ rnd(w(p + "gate_proj.weight")).T
    u = rnd(x) @ rnd(w(p + "up_proj.weight")).T
    return rnd(F.silu(g) * u) @ rnd(w(p + "down_proj.weight")).T


def experts(cfg: dict, x: torch.Tensor, w: Callable[[str], torch.Tensor], p: str,
            rnd=_same, rnd_router=None, rnd_experts=None, top_e=None,
            shared: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over token rows x [N, hidden]: (its output, each
    token's chosen experts [N, k]); ``rnd_router`` rounds the router's
    operands, ``rnd_experts`` the routed experts' (``rnd`` by default).
    ``top_e`` [N, k] takes those experts in place of the router's top-k,
    each weighted by its probability under the router; ``shared=False``
    leaves out the shared experts (the routed experts' weighted sum)."""
    rr = rnd if rnd_router is None else rnd_router
    rx = rnd if rnd_experts is None else rnd_experts
    logits = rr(x.float()) @ rr(w(p + "gate.weight").float()).T
    probs = torch.softmax(logits, dim=-1)
    if top_e is None:
        top_w, top_e = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    else:
        top_w = torch.gather(probs, 1, top_e)
    top_w = top_w * cfg["routed_scaling_factor"]
    out = swiglu(x, w, p + "shared_experts.", rnd) if shared else torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x.index_select(0, tok), w, f"{p}experts.{e}.", rx)
        out = out.index_add(0, tok, y * top_w[tok, slot][:, None])
    return out, top_e


def rope_tables(cfg: dict, lengths: Sequence[int], device) -> Dict[int, Tuple[torch.Tensor,
                                                                                 torch.Tensor]]:
    """cos, sin [L, rope] of each sequence length L: YaRN's frequencies,
    scaled by ``mscale / mscale_all_dim``."""
    rs = cfg["rope_scaling"]
    scale = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"],
                                                                 rs["mscale_all_dim"])
    inv = yarn_inv_freq(cfg).to(device)
    trig = {}
    for n_len in set(lengths):
        f = torch.arange(n_len, device=device, dtype=torch.float32)[:, None] * inv[None]
        emb = torch.cat([f, f], dim=-1)
        trig[n_len] = (emb.cos() * scale, emb.sin() * scale)
    return trig


def layer_leaves(leaf: Callable[[str], torch.Tensor]) -> Callable[[str], torch.Tensor]:
    """``leaf`` with each weight made once: one layer's weights, held
    while its blocks run."""
    cache: Dict[str, torch.Tensor] = {}

    def w(name):
        if name not in cache:
            cache[name] = leaf(name)
        return cache[name]

    return w


def block(cfg: dict, w: Callable[[str], torch.Tensor], i: int, kind: str, h: torch.Tensor,
          lengths: Sequence[int], trig, rnd=_same, rnd_router=None, rnd_experts=None,
          top_e=None):
    """Layer ``i``'s block ``kind`` ("attn"; "mlp", the dense SwiGLU or the
    expert layer; "routed", the expert layer's routed experts alone) on its
    input rows h [N, hidden] (the sequences' tokens in order, after the
    block's RMSNorm) -> (its output [N, hidden], the expert layer's choices
    [N, k] or None)."""
    p = f"model.layers.{i}."
    if kind == "attn":
        parts, lo = [], 0
        for n_len in lengths:
            parts.append(attention(cfg, h[lo:lo + n_len], w, p + "self_attn.", *trig[n_len], rnd))
            lo += n_len
        return torch.cat(parts), None
    if i < cfg["first_k_dense_replace"]:
        return swiglu(h, w, p + "mlp.", rnd), None
    return experts(cfg, h, w, p + "mlp.", rnd, rnd_router, rnd_experts, top_e,
                   shared=kind == "mlp")


def embed_sequences(cfg: dict, leaf: Callable[[str], torch.Tensor], seqs: Sequence[torch.Tensor],
                    rnd=_same, rnd_router=None, rnd_experts=None,
                    record=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(embeddings [S, hidden] f32, each expert layer's choices [N, k] over
    the sequences' tokens in order) of token-id sequences ``seqs`` (each a
    1-D tensor ending in the end-of-sequence id). ``leaf(name)`` gives a
    weight by its Hugging Face name, in f32; ``rnd_router`` and
    ``rnd_experts`` round the routers' or the routed experts' operands
    alone (``rnd`` by default). A ``record`` list gets each block's
    ``(layer, kind, input rows, expert choices or None)``."""
    eps = cfg["rms_norm_eps"]
    lengths = [int(s.numel()) for s in seqs]
    ids = torch.cat([s.long() for s in seqs])
    with torch.no_grad():
        x = leaf("model.embed_tokens.weight")[ids]
        trig = rope_tables(cfg, lengths, x.device)
        choices = []
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."
            w = layer_leaves(leaf)
            h = rms_norm(x, w(p + "input_layernorm.weight"), eps)
            a, _ = block(cfg, w, i, "attn", h, lengths, trig, rnd)
            if record is not None:
                record.append((i, "attn", h, None))
            x = x + a
            h = rms_norm(x, w(p + "post_attention_layernorm.weight"), eps)
            y, top_e = block(cfg, w, i, "mlp", h, lengths, trig, rnd, rnd_router, rnd_experts)
            if record is not None:
                record.append((i, "mlp", h, top_e))
            x = x + y
            if top_e is not None:
                choices.append(top_e)
            del w
        last = torch.tensor(lengths, device=x.device).cumsum(0) - 1
        out = rms_norm(x[last], leaf("model.norm.weight"), eps)
        return F.normalize(out, dim=-1), choices
