"""The plain encoder: a BERT / RoBERTa forward in plain PyTorch.

Written from the published architectures (post-LN Transformer encoder,
exact-erf GELU, learned absolute positions; RoBERTa's positions count the
valid tokens from ``pad_token_id + 1``), with the ANCE head (a linear layer
and a LayerNorm on the first token) or DPR's [CLS] pooling. It takes the
weights by their Hugging Face names and imports nothing of the program.
Attention masks the padded keys of each row; a padded query row's output
feeds no pooled embedding. f32 throughout; the caller sets TF32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def tower_prefix(cfg: dict, side: str) -> str:
    """The weights' prefix of the tower that embeds ``side`` ("query" or
    "body")."""
    if cfg["towers"] == 2:
        return "question_model." if side == "query" else "ctx_model."
    return "roberta."


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _linear(x, w: Dict[str, torch.Tensor], name: str, rnd=_same):
    return rnd(x) @ rnd(w[name + ".weight"]).T + w[name + ".bias"]


def _norm(x, w, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"], w[name + ".bias"], eps)


def sequence_output(w: Dict[str, torch.Tensor], cfg: dict, prefix: str,
                    ids: torch.Tensor, mask: torch.Tensor, rnd=_same) -> torch.Tensor:
    """[B, T, hidden] of one tower; ``rnd`` rounds both operands of every
    product (a control's lower precision), the identity by default."""
    ids, valid = ids.long(), mask.bool()
    b, t = ids.shape
    if cfg["position_ids"] == "roberta":
        pos = torch.cumsum(valid.long(), dim=1) * valid.long() + cfg["pad_token_id"]
    else:
        pos = torch.arange(t, device=ids.device).expand(b, t)
    e = prefix + "embeddings."
    x = w[e + "word_embeddings.weight"][ids] + w[e + "position_embeddings.weight"][pos]
    if cfg["type_vocab_size"] > 0:
        x = x + w[e + "token_type_embeddings.weight"][0]
    eps = cfg["layer_norm_eps"]
    x = _norm(x, w, e + "LayerNorm", eps)
    # "gelu" is the exact erf form; any other (gelu_new, gelu_pytorch_tanh) the tanh one
    gelu = "none" if cfg["hidden_act"] == "gelu" else "tanh"
    heads = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // heads
    key_bias = torch.zeros((b, 1, 1, t), device=ids.device)
    key_bias = key_bias.masked_fill(~valid[:, None, None, :], float("-inf"))
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{prefix}encoder.layer.{layer}."

        def split(y):
            return y.view(b, t, heads, dh).transpose(1, 2)

        q = split(_linear(x, w, p + "attention.self.query", rnd))
        k = split(_linear(x, w, p + "attention.self.key", rnd))
        v = split(_linear(x, w, p + "attention.self.value", rnd))
        probs = torch.softmax(rnd(q) @ rnd(k).transpose(-1, -2) / dh ** 0.5 + key_bias, dim=-1)
        ctx = (rnd(probs) @ rnd(v)).transpose(1, 2).reshape(b, t, heads * dh)
        x = _norm(x + _linear(ctx, w, p + "attention.output.dense", rnd), w,
                  p + "attention.output.LayerNorm", eps)
        f = F.gelu(_linear(x, w, p + "intermediate.dense", rnd), approximate=gelu)
        x = _norm(x + _linear(f, w, p + "output.dense", rnd), w, p + "output.LayerNorm", eps)
    return x


def embed(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
          side: str = "query", rnd=_same) -> torch.Tensor:
    """[B, embedding_dim] f32 embeddings of ``side``."""
    first = sequence_output(w, cfg, tower_prefix(cfg, side), ids, mask, rnd)[:, 0]
    if cfg["head"] == "linear_layernorm":
        first = _norm(_linear(first, w, "embeddingHead", rnd), w, "norm",
                      cfg["head_layer_norm_eps"])
    return first


def embed_rows(w, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, side: str = "query",
               rows: int = 64, rnd=_same) -> torch.Tensor:
    """:func:`embed` over blocks of ``rows`` rows, without autograd."""
    with torch.no_grad():
        return torch.cat([embed(w, cfg, ids[i:i + rows], mask[i:i + rows], side, rnd)
                          for i in range(0, ids.shape[0], rows)])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude onto the format's 448), back in ``t``'s dtype: the operand
    rounding of an fp8 product with f32 accumulation."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
