"""Transformer encoder (BERT/RoBERTa topology) as PyTorch modules.

The counterpart of ``convdr_tpu/models/transformer.py``. One module covers
both families via :class:`~convdr_torch.core.config.EncoderArchConfig`:

  * RoBERTa: position ids ``cumsum(mask) * mask + pad_token_id``, layer
    norm eps 1e-5, single token type;
  * BERT: positions from 0, eps 1e-12, two token types.

Submodule names follow the Hugging Face state-dict layout
(``embeddings.word_embeddings``, ``encoder.layer.{i}.attention.self.query``,
...), so reference ``pytorch_model.bin`` files load without renaming.

Numerics follow the JAX package: post-LN layers; every LayerNorm computes in
f32 on f32 parameters and the layer casts the result back to the compute
dtype; linear layers and embeddings run in the compute dtype (f32, or bf16
via :func:`to_compute_dtype`). Attention takes the [B, T] 0/1 mask as
segment ids (:mod:`convdr_torch.models.attention`); in training its
gradient goes through the flash backward. The modules hold no dropout:
the deterministic step is the JAX package's default, and training with
dropout is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from convdr_torch.core.config import EncoderArchConfig
from convdr_torch.models.attention import flash_attention


class LayerNorm32(nn.LayerNorm):
    """LayerNorm in f32 on f32 parameters; returns f32 (callers cast)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast linear layers and embeddings to ``dtype``; LayerNorms stay f32
    (the JAX package keeps parameters f32 and runs LayerNorm in f32)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(dtype)
    return model


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = nn.Embedding(
                cfg.type_vocab_size, cfg.hidden_size
            )
        self.LayerNorm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def position_ids(self, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.position_offset > 0:
            # RoBERTa: cumulative index over non-pad positions, offset past pad.
            mask = attention_mask.to(torch.int64)
            return torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        t = attention_mask.shape[1]
        return torch.arange(t, device=attention_mask.device)[None, :].expand(
            attention_mask.shape
        )

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        hidden = self.word_embeddings(input_ids) + self.position_embeddings(
            self.position_ids(attention_mask)
        )
        if self.cfg.type_vocab_size > 0:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            hidden = hidden + self.token_type_embeddings(token_type_ids)
        return self.LayerNorm(hidden).to(hidden.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class DenseNorm(nn.Module):
    """``dense`` + residual LayerNorm (HF ``*Output`` blocks)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = LayerNorm32(d_out, eps=eps)

    def forward(self, x, residual):
        out = self.dense(x)
        return self.LayerNorm(residual + out).to(out.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.self = SelfAttention(cfg)
        self.output = DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, hidden, attention_mask):
        b, t, h = hidden.shape
        shape = (b, t, self.num_heads, h // self.num_heads)
        q = self.self.query(hidden).view(shape)
        k = self.self.key(hidden).view(shape)
        v = self.self.value(hidden).view(shape)
        ctx = flash_attention(q, k, v, attention_mask)
        return self.output(ctx.reshape(b, t, h), hidden)


class Intermediate(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.approximate = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x):
        return F.gelu(self.dense(x), approximate=self.approximate)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = DenseNorm(
            cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps
        )

    def forward(self, hidden, attention_mask):
        hidden = self.attention(hidden, attention_mask)
        return self.output(self.intermediate(hidden), hidden)


class LayerStack(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_layers)
        )


class TransformerEncoder(nn.Module):
    """Token ids + mask -> contextual sequence output [B, T, H]."""

    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = LayerStack(cfg)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hidden = self.embeddings(input_ids, attention_mask, token_type_ids)
        # the attention kernels take int32 segment ids: made once a forward
        seg = attention_mask.to(torch.int32).contiguous()
        for layer in self.encoder.layer:
            hidden = layer(hidden, seg)
        return hidden
