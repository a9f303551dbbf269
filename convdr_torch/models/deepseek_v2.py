"""DeepSeek-V2 as a RepLLaMA-style dense retriever (arXiv:2310.08319).

The decoder stack (DeepSeek-V2, arXiv:2405.04434) keeps its causal mask;
a passage or query ends in the end-of-sequence token the tokenizer
appends, and that token's final hidden state, after the last RMSNorm and
L2-normalised, is the embedding. Queries and passages share the tower
(``query_emb == body_emb``). Per layer, with h the block's input and
pre-norm RMSNorms (eps ``rms_norm_eps``):

  * latent attention, no q-LoRA: ``q = W_q h`` split per head into
    [q_nope | q_pe]; ``[c_kv | k_pe] = W_kva h`` with ``c_kv`` RMS-normed;
    ``[k_nope | v] = W_kvb c_kv`` per head; k_pe is shared by the heads;
    the rotary half (``qk_rope_head_dim``) is de-interleaved (view
    (d / 2, 2), transpose) before rotate-half, as the published
    ``apply_rotary_pos_emb``; YaRN frequencies; a causal softmax over
    valid keys with scale ``qk_head_dim^-0.5 * m^2``, ``m = 0.1
    mscale_all_dim ln(factor) + 1``; ``o = W_o [o_1 ... o_H]``;
  * the first ``first_k_dense_replace`` layers a dense SwiGLU, the rest a
    routed expert layer (:mod:`convdr_torch.ops.moe`): a softmax router
    over the routed experts, greedy top-k, not renormalised, times
    ``routed_scaling_factor``, plus the shared experts as one SwiGLU of
    ``n_shared_experts * moe_intermediate_size``.

The forward runs on the valid tokens alone: the batch's valid positions
are packed into rows [N, H] once (one host sync a forward, for N), every
per-token layer (projections, norms, experts) runs on those rows, and
attention scatters its operands into the padded [B, T, H, D] layout of
kernel 1's causal variant (:func:`~convdr_torch.models.attention.
causal_attention`) and gathers its output back. Pads take no expert
capacity.

Parameter names are Hugging Face's (``model.layers.N.self_attn.
kv_a_proj_with_mqa.weight``, ...) except the routed experts, held
stacked as ``mlp.experts.{gate,up,down}_proj`` [E, ...];
:meth:`DeepseekV2Encoder.load_hf_leaf` takes a checkpoint's leaves by
their own names (``mlp.experts.E.gate_proj.weight``). The output head
(``lm_head``) is not held: retrieval never reads it.

Spans (recorded only while a profiler runs): ``convdr.mla.attention``
around each attention block, ``convdr.moe.experts`` around each expert
layer, ``convdr.moe.route`` around its router and ordering. Each expert
layer accumulates its routed rows per expert on the device, with no sync;
:func:`moe_stats` reads them once. Inside :func:`recording_blocks` each
layer also keeps its attention and MLP blocks' input and output rows, and
each expert layer the experts it routed its rows to and their weighted
sum: what a check holds to an exact computation on the program's own
inputs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterable, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from convdr_torch.core.config import DecoderArchConfig, ModelConfig
from convdr_torch.models.attention import causal_attention
from convdr_torch.ops import moe
from convdr_torch.utils.observability import span

# ---------------------------------------------------------------------------
# YaRN (DeepSeek-V2's DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------


def yarn_correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_correction_range(low_rot: float, high_rot: float, dim: int, base: float,
                          max_pos: int):
    low = math.floor(yarn_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(yarn_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DecoderArchConfig) -> torch.Tensor:
    """[rope_dim / 2] f32: the original frequencies where the ramp is 0
    (high frequencies), divided by ``factor`` where it is 1, linear
    between (``yarn_linear_ramp_mask`` over ``yarn_find_correction_range``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq = 1.0 / base ** exps
    low, high = yarn_correction_range(cfg.rope_beta_fast, cfg.rope_beta_slow, dim, base,
                                      cfg.rope_original_max_position)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return freq / cfg.rope_factor * ramp + freq * (1 - ramp)


def softmax_scale(cfg: DecoderArchConfig) -> float:
    """``qk_head_dim^-0.5`` times YaRN's ``mscale(factor, mscale_all_dim)^2``."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return cfg.qk_head_dim ** -0.5 * m * m


def rope_cos_sin(cfg: DecoderArchConfig, positions: torch.Tensor):
    """cos, sin [N, rope_dim] f32 at ``positions`` [N] (the two halves
    alike), scaled by mscale / mscale_all_dim."""
    freqs = positions.float()[:, None] * yarn_inv_freq(cfg).to(positions.device)[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(
        cfg.rope_factor, cfg.rope_mscale_all_dim)
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, ..., d] rotated at each row's position: de-interleaved, then
    ``x cos + rotate_half(x) sin`` in f32, in x's dtype."""
    shape = x.shape
    d = shape[-1]
    xf = x.float().reshape(*shape[:-1], d // 2, 2).transpose(-1, -2).reshape(shape)
    half = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    extra = (1,) * (x.dim() - 2)
    c = cos.view(cos.shape[0], *extra, d)
    s = sin.view(sin.shape[0], *extra, d)
    return (xf * c + half * s).to(x.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """``w * x / sqrt(mean(x^2) + eps)`` in f32, in x's dtype. The weight
    stays f32 under :func:`~convdr_torch.models.transformer.to_compute_dtype`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight.float(), self.eps).to(x.dtype)


def _linear(d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False)


class SwiGLU(nn.Module):
    """``down(silu(gate x) * up x)``: the dense layers' MLP and the shared
    experts (``mlp.shared_experts.*``)."""

    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = _linear(hidden, inter)
        self.up_proj = _linear(hidden, inter)
        self.down_proj = _linear(inter, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    """Multi-head latent attention with no q-LoRA (``self_attn.*``)."""

    def __init__(self, cfg: DecoderArchConfig):
        super().__init__()
        if cfg.q_lora_rank is not None:
            raise ValueError("q_lora_rank is not supported: DeepSeek-V2-Lite has none")
        h, heads = cfg.hidden_size, cfg.num_heads
        self.cfg = cfg
        self.q_proj = _linear(h, heads * cfg.qk_head_dim)
        self.kv_a_proj_with_mqa = _linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _linear(cfg.kv_lora_rank,
                                 heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = _linear(heads * cfg.v_head_dim, h)
        self.scale = softmax_scale(cfg)

    def forward(self, x: torch.Tensor, rows: "PackedBatch") -> torch.Tensor:
        cfg = self.cfg
        n, heads = x.shape[0], cfg.num_heads
        nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q = self.q_proj(x).view(n, heads, nope + rope)
        q[..., nope:] = apply_rope(q[..., nope:], rows.cos, rows.sin)
        ckv = self.kv_a_proj_with_mqa(x)
        kv = self.kv_b_proj(self.kv_a_layernorm(ckv[:, : cfg.kv_lora_rank]))
        kv = kv.view(n, heads, nope + dv)
        k_pe = apply_rope(ckv[:, None, cfg.kv_lora_rank:], rows.cos, rows.sin)
        # the padded operands, each part scattered into its columns
        qp, kp, vp = rows.padded(x, heads, nope + rope, dv)
        qp.index_copy_(0, rows.index, q)
        kp[..., :nope].index_copy_(0, rows.index, kv[..., :nope])
        kp[..., nope:].index_copy_(0, rows.index, k_pe.expand(n, heads, rope))
        vp.index_copy_(0, rows.index, kv[..., nope:])
        b, t = rows.shape
        out = causal_attention(qp.view(b, t, heads, -1), kp.view(b, t, heads, -1),
                               vp.view(b, t, heads, -1), rows.mask, self.scale)
        return self.o_proj(rows.take(out).reshape(n, heads * dv))


class RoutedExperts(nn.Module):
    """The routed experts stacked (``mlp.experts.*``): gate_proj and
    up_proj [E, I, H], down_proj [E, H, I]. Cast with the linear layers
    (``cast_with_linears``)."""

    cast_with_linears = True

    def __init__(self, n: int, hidden: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(n, inter, hidden))
        self.up_proj = nn.Parameter(torch.empty(n, inter, hidden))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, inter))


class Router(nn.Module):
    """``mlp.gate``: the router's weight [E, H], kept f32 (its logits are
    taken in f32)."""

    def __init__(self, n: int, hidden: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, hidden))


class ExpertLayer(nn.Module):
    """The routed experts beside the shared ones (``mlp.*``); counts its
    routed rows per expert on the device."""

    def __init__(self, cfg: DecoderArchConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg.n_routed_experts, cfg.hidden_size)
        self.experts = RoutedExperts(cfg.n_routed_experts, cfg.hidden_size,
                                     cfg.moe_intermediate_size)
        self.shared_experts = SwiGLU(cfg.hidden_size,
                                     cfg.n_shared_experts * cfg.moe_intermediate_size)
        self.reset_stats()
        self.routing: Optional[list] = None  # (experts, routed sum) a call, in recording_blocks

    def reset_stats(self) -> None:
        self.routed_rows: Optional[torch.Tensor] = None  # [E] int64, on the device
        self.load_ratio: Optional[torch.Tensor] = None  # sum of max / mean a call
        self.calls = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with span("convdr.moe.route"):
            weights, experts = moe.route(x, self.gate.weight, cfg.num_experts_per_tok,
                                         cfg.routed_scaling_factor)
            slots, counts, row_off, tile_off = moe.order_by_expert(experts,
                                                                   cfg.n_routed_experts)
        self._count(counts)
        w = self.experts
        y = moe.grouped_swiglu(x, slots, row_off, tile_off, weights, w.gate_proj, w.up_proj,
                               w.down_proj)
        out = moe.combine(y, cfg.num_experts_per_tok)
        if self.routing is not None:
            self.routing.append((experts, out.clone()))
        return out.add_(self.shared_experts(x)).to(x.dtype)

    @torch.no_grad()
    def _count(self, counts: torch.Tensor) -> None:
        ratio = counts.max().float() / counts.float().mean()
        if self.routed_rows is None:
            self.routed_rows, self.load_ratio = counts, ratio
        else:  # new tensors: a counter made under inference mode stays usable outside it
            self.routed_rows = self.routed_rows + counts
            self.load_ratio = self.load_ratio + ratio
        self.calls += 1


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderArchConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LatentAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size)
                    if index < cfg.first_k_dense_replace else ExpertLayer(cfg))
        self.blocks: Optional[list] = None  # (kind, input, output), inside recording_blocks

    def forward(self, x: torch.Tensor, rows: "PackedBatch") -> torch.Tensor:
        # each block's input and output are dropped once used unless recorded
        with span("convdr.mla.attention"):
            h = self.input_layernorm(x)
            a = self.self_attn(h, rows)
            if self.blocks is not None:
                self.blocks.append(("attn", h, a))
            del h
            x = x + a
            del a
        routed = isinstance(self.mlp, ExpertLayer)
        with span("convdr.moe.experts") if routed else contextlib.nullcontext():
            g = self.post_attention_layernorm(x)
            m = self.mlp(g)
            if self.blocks is not None:
                self.blocks.append(("mlp", g, m))
            del g
            return x + m


class PackedBatch:
    """A batch's valid tokens as rows: ``index`` [N] their flat positions
    ``b * T + t`` in order (right padding: each sequence's tokens are a
    prefix of its row), their positions' rotary cos and sin, each
    sequence's last valid row, attention's padded buffers and the gather
    back from the padded layout."""

    def __init__(self, cfg: DecoderArchConfig, mask: torch.Tensor):
        b, t = mask.shape
        self.shape = (b, t)
        self.mask = mask.to(torch.int32).contiguous()
        flat = self.mask.reshape(-1)
        self.index = torch.nonzero(flat).squeeze(1)  # one host sync a forward
        self.cos, self.sin = rope_cos_sin(cfg, self.index % t)
        self.last = torch.cumsum(self.mask.sum(1), 0) - 1  # [B] packed rows
        self.buffers = None

    def padded(self, x: torch.Tensor, heads: int, qk_dim: int, v_dim: int):
        """The attention operands' padded buffers q, k [B T, heads, qk_dim]
        and v [B T, heads, v_dim] in x's dtype, made zero once a forward:
        each layer writes only the valid rows, so the pads stay zero."""
        if self.buffers is None:
            b, t = self.shape
            self.buffers = tuple(x.new_zeros((b * t, heads, d)) for d in (qk_dim, qk_dim, v_dim))
        return self.buffers

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, ...] -> the valid rows [N, ...]."""
        b, t = self.shape
        return x.reshape(b * t, *x.shape[2:])[self.index]


class DeepseekV2Model(nn.Module):
    """``model.*``: the embedding, the layers and the final norm."""

    def __init__(self, cfg: DecoderArchConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class DeepseekV2Encoder(nn.Module):
    """One shared tower; ``query_emb`` / ``body_emb`` / ``forward`` with
    the signatures of the port's other encoders -> [B, hidden] f32 (or f64
    under f64 parameters), L2-normalised."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        if not isinstance(config.arch, DecoderArchConfig):
            raise TypeError("DeepseekV2Encoder takes a DecoderArchConfig")
        self.config = config
        self.model = DeepseekV2Model(config.arch)

    def _encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        rows = PackedBatch(self.config.arch, attention_mask)
        x = self.model.embed_tokens(input_ids.reshape(-1)[rows.index])
        for layer in self.model.layers:
            x = layer(x, rows)
        last = self.model.norm(x[rows.last])
        emb = last.to(torch.promote_types(last.dtype, torch.float32))
        return F.normalize(emb, dim=-1)

    def query_emb(self, input_ids, attention_mask, packing=None):
        return self._encode(input_ids, attention_mask)

    def body_emb(self, input_ids, attention_mask):
        return self._encode(input_ids, attention_mask)

    def forward(self, input_ids, attention_mask, *, is_query: bool = True):
        return self._encode(input_ids, attention_mask)

    @torch.no_grad()
    def load_hf_leaf(self, name: str, tensor: torch.Tensor) -> None:
        """Copy one checkpoint leaf, by its Hugging Face name, into the
        parameter (or the routed expert's slice) that holds it. The output
        head is skipped."""
        if name == "lm_head.weight":
            return
        parts = name.split(".")
        if "experts" in parts and parts[parts.index("experts") + 1].isdigit():
            i = parts.index("experts")
            stacked = ".".join(parts[:i + 1] + [parts[i + 2]])
            self.get_parameter(stacked)[int(parts[i + 1])].copy_(tensor)
            return
        self.get_parameter(name).copy_(tensor)

    def load_hf_leaves(self, leaves: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Every leaf the encoder holds from ``(name, tensor)`` pairs taken
        one at a time (a checkpoint's or a seeded source's), each filled
        exactly once, or it raises."""
        want = hf_leaf_names(self.config.arch)
        got = set()
        for name, tensor in leaves:
            if name == "lm_head.weight":
                continue
            if name not in want or name in got:
                raise KeyError(f"checkpoint leaf {name!r}: "
                               f"{'repeated' if name in got else 'unexpected'}")
            self.load_hf_leaf(name, tensor)
            got.add(name)
        if got != want:
            raise KeyError(f"checkpoint leaves: missing {sorted(want - got)[:5]}")


def hf_leaf_names(cfg: DecoderArchConfig) -> set:
    """The Hugging Face names of every leaf the encoder holds."""
    names = {"model.embed_tokens.weight", "model.norm.weight"}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        names |= {p + n for n in (
            "input_layernorm.weight", "post_attention_layernorm.weight",
            "self_attn.q_proj.weight", "self_attn.kv_a_proj_with_mqa.weight",
            "self_attn.kv_a_layernorm.weight", "self_attn.kv_b_proj.weight",
            "self_attn.o_proj.weight")}
        proj = ("gate_proj", "up_proj", "down_proj")
        if i < cfg.first_k_dense_replace:
            names |= {f"{p}mlp.{w}.weight" for w in proj}
        else:
            names |= {f"{p}mlp.gate.weight"} | {f"{p}mlp.shared_experts.{w}.weight"
                                                for w in proj}
            names |= {f"{p}mlp.experts.{e}.{w}.weight" for e in range(cfg.n_routed_experts)
                      for w in proj}
    return names


def moe_stats(model: nn.Module) -> dict:
    """The expert layers' counters since their last reset, read in one
    copy: ``routed_rows`` [layers][E], ``calls`` and ``load_max_mean``,
    the most-loaded expert's routed rows over the mean, averaged over
    layers and calls (None before any call)."""
    layers = [m for m in model.modules() if isinstance(m, ExpertLayer)]
    live = [m for m in layers if m.calls]
    if not live:
        return {"routed_rows": [], "calls": 0, "load_max_mean": None}
    rows = torch.stack([m.routed_rows for m in live]).cpu()
    ratios = torch.stack([m.load_ratio for m in live]).cpu()
    calls = sum(m.calls for m in live)
    return {"routed_rows": rows.tolist(), "calls": calls,
            "load_max_mean": float(ratios.sum()) / calls}


@contextlib.contextmanager
def recording_blocks(model: nn.Module) -> Iterator[List[dict]]:
    """Inside the block every decoder layer keeps, call by call, its
    attention and MLP blocks as ``(kind, input rows [N, H], output rows
    [N, H])`` ("attn", "mlp"; the input after the block's RMSNorm, the
    output before the residual add), and each expert layer the experts
    [N, k] its router chose, as routed, with their weighted sum [N, H]
    (f32, the shared experts' output not yet added). Yields one dict a
    layer, in layer order: ``{"blocks": [...], "experts": [(experts,
    routed sum)] or None}``."""
    layers = [m for m in model.modules() if isinstance(m, DecoderLayer)]
    out = []
    for m in layers:
        m.blocks = []
        if isinstance(m.mlp, ExpertLayer):
            m.mlp.routing = []
        out.append({"blocks": m.blocks,
                    "experts": m.mlp.routing if isinstance(m.mlp, ExpertLayer) else None})
    try:
        yield out
    finally:
        for m in layers:
            m.blocks = None
            if isinstance(m.mlp, ExpertLayer):
                m.mlp.routing = None


def reset_moe_stats(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, ExpertLayer):
            m.reset_stats()
