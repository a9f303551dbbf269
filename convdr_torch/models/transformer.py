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
dtype; linear layers and embeddings run in the compute dtype. Inference
casts their parameters to it once (:func:`to_compute_dtype`); training
keeps f32 master parameters and casts them where they are used
(:func:`cast_at_use`), as flax's ``dtype=`` does, so the gradients that
reach the parameters are f32. Attention takes the [B, T] 0/1 mask as
segment ids (:mod:`convdr_torch.models.attention`); in training its
gradient goes through the flash backward.

Dropout sits at the JAX package's sites (the embeddings' output, the
attention probabilities, the attention and FFN outputs) and drops only in
``train()`` mode while a generator is set (:func:`set_dropout_generator`,
which the train step does under ``use_dropout``): a step without it drops
nothing. While attention dropout is active a layer's attention is the plain
einsum with dropout on the probabilities, the JAX package's own dispatch
(``convdr_tpu/models/transformer.py:50-75``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from convdr_torch.core.config import EncoderArchConfig
from convdr_torch.models.attention import (
    at_least_f32,
    dropout_attention_plain,
    flash_attention,
)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm in f32 on f32 parameters; returns f32 (callers cast).
    f64 inputs and parameters stay f64."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            at_least_f32(x), self.normalized_shape, at_least_f32(self.weight),
            at_least_f32(self.bias), self.eps,
        )


class CastLinear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to ``compute_dtype``
    where they are used (flax's ``Dense(dtype=)``): f32 parameters, products
    in the compute dtype, f32 gradients back through the cast. None computes
    in the parameters' own dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


class CastEmbedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``compute_dtype`` (flax's
    ``Embed(dtype=)``). The rows are gathered, then cast: the same values
    as casting the table first, and the gradient scatters in f32."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = super().forward(ids)
        return rows if self.compute_dtype is None else rows.to(self.compute_dtype)


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast linear layers and embeddings to ``dtype``; LayerNorms stay f32
    (the JAX package keeps parameters f32 and runs LayerNorm in f32). For
    inference and the frozen teacher."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(dtype)
    return model


def cast_at_use(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Keep every parameter as it is (f32 masters) and run linear layers and
    embeddings in ``dtype``, casting their parameters where they are used.
    For training in bf16: the optimizer updates the f32 masters."""
    for m in model.modules():
        if isinstance(m, (CastLinear, CastEmbedding)):
            m.compute_dtype = None if dtype == m.weight.dtype else dtype
    return model


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: ``x / (1 - p)`` where a uniform draw keeps it,
    0 elsewhere. It drops only in ``train()`` mode with ``p > 0`` and while
    a generator is set (:func:`set_dropout_generator`); ``active`` is the
    JAX package's ``not deterministic and rate > 0``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        return self.training and self.p > 0.0 and self.generator is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every dropout site of ``model`` the random stream ``generator``
    (drawn in forward order), or None to switch dropout off."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = CastEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = CastEmbedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = CastEmbedding(
                cfg.type_vocab_size, cfg.hidden_size
            )
        self.LayerNorm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout)

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
        return self.dropout(self.LayerNorm(hidden).to(hidden.dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.query = CastLinear(cfg.hidden_size, cfg.hidden_size)
        self.key = CastLinear(cfg.hidden_size, cfg.hidden_size)
        self.value = CastLinear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.attention_dropout)  # on the probabilities


class DenseNorm(nn.Module):
    """``dense`` + dropout + residual LayerNorm (HF ``*Output`` blocks)."""

    def __init__(self, d_in: int, d_out: int, eps: float, dropout: float):
        super().__init__()
        self.dense = CastLinear(d_in, d_out)
        self.LayerNorm = LayerNorm32(d_out, eps=eps)
        self.dropout = Dropout(dropout)

    def forward(self, x, residual):
        out = self.dropout(self.dense(x))
        return self.LayerNorm(residual + out).to(out.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.self = SelfAttention(cfg)
        self.output = DenseNorm(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps,
                                cfg.hidden_dropout)

    def forward(self, hidden, attention_mask):
        b, t, h = hidden.shape
        shape = (b, t, self.num_heads, h // self.num_heads)
        q = self.self.query(hidden).view(shape)
        k = self.self.key(hidden).view(shape)
        v = self.self.value(hidden).view(shape)
        if self.self.dropout.active():
            ctx = dropout_attention_plain(q, k, v, attention_mask, self.self.dropout)
        else:
            ctx = flash_attention(q, k, v, attention_mask)
        return self.output(ctx.reshape(b, t, h), hidden)


class Intermediate(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.dense = CastLinear(cfg.hidden_size, cfg.intermediate_size)
        self.approximate = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x):
        return F.gelu(self.dense(x), approximate=self.approximate)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderArchConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = DenseNorm(
            cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps, cfg.hidden_dropout
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
