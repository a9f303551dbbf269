"""Dense retrieval encoders: ANCE-style dot encoder and DPR bi-encoder.

The counterpart of ``convdr_tpu/models/encoders.py`` (reference
model/models.py):

  * :class:`AnceEncoder` == ``RobertaDot_NLL_LN`` (models.py:129-148):
    shared RoBERTa backbone, first-token (or masked-mean) pooling
    (models.py:32-43), ``Linear(hidden -> 768)`` projection + LayerNorm head
    (models.py:136-137,144). ``query_emb == body_emb``. Its state dict has
    the reference's keys: ``roberta.*``, ``embeddingHead.*``, ``norm.*``.
  * multi-chunk FirstP == ``RobertaDot_CLF_ANN_NLL_MultiChunk``
    (models.py:159-188): a ``[B, C*L]`` document is reshaped to ``[B*C, L]``,
    chunks encoded independently, ``body_emb`` returns ``[B, C, E]``; scoring
    takes the max chunk inner product with a ``-9999`` bias on empty chunks
    (models.py:100-118).
  * :class:`DPRBiEncoder` == ``BiEncoder`` (models.py:219-262): two
    independent BERT towers (``question_model.*``, ``ctx_model.*``), CLS
    pooling (models.py:210).
"""

from __future__ import annotations

import torch
from torch import nn

from convdr_torch.core.config import ModelConfig
from convdr_torch.models.attention import at_least_f32
from convdr_torch.models.transformer import CastLinear, LayerNorm32, TransformerEncoder

CHUNK_MASK_BIAS = -9999.0


def masked_mean(seq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid positions (models.py:32-35)."""
    m = mask.to(seq.dtype)[..., None]
    return torch.sum(seq * m, dim=1) / torch.sum(m, dim=1)


def pool(seq: torch.Tensor, mask: torch.Tensor, use_mean: bool) -> torch.Tensor:
    """Masked mean or first token ([CLS]) pooling (models.py:37-43), in the
    sequence's (compute) dtype."""
    if use_mean:
        return masked_mean(seq, mask)
    return seq[:, 0]


class AnceEncoder(nn.Module):
    """Shared-tower dot-product encoder with projection head + LayerNorm."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.roberta = TransformerEncoder(config.arch)
        if config.projection_head:
            self.embeddingHead = CastLinear(
                config.arch.hidden_size, config.embedding_dim
            )
            self.norm = LayerNorm32(config.embedding_dim, eps=1e-5)

    def _encode(self, input_ids, attention_mask):
        seq = self.roberta(input_ids, attention_mask)
        emb = pool(seq, attention_mask, self.config.use_mean)
        if self.config.projection_head:
            # the head in the compute dtype, its LayerNorm in f32
            emb = self.norm(self.embeddingHead(emb))
        return at_least_f32(emb)

    def query_emb(self, input_ids, attention_mask):
        return self._encode(input_ids, attention_mask)

    def body_emb(self, input_ids, attention_mask):
        if not self.config.multi_chunk:
            return self._encode(input_ids, attention_mask)
        # FirstP multi-chunk: [B, C*L] -> [B*C, L] -> [B, C, E].
        b, full_len = input_ids.shape
        chunk_len = self.config.chunk_len
        c = full_len // chunk_len
        ids = input_ids.reshape(b * c, chunk_len)
        mask = attention_mask.reshape(b * c, chunk_len)
        return self._encode(ids, mask).reshape(b, c, -1)

    def forward(self, input_ids, attention_mask, *, is_query: bool = True):
        if is_query:
            return self.query_emb(input_ids, attention_mask)
        return self.body_emb(input_ids, attention_mask)


def multi_chunk_scores(
    q_embs: torch.Tensor, doc_embs: torch.Tensor, doc_mask: torch.Tensor,
    chunk_len: int,
) -> torch.Tensor:
    """Max-over-chunks inner product with empty-chunk bias (models.py:96-118).

    q_embs [B, E], doc_embs [B, C, E], doc_mask [B, C*L] -> scores [B].
    """
    b, c, _ = doc_embs.shape
    chunk_valid = doc_mask.reshape(b, c, chunk_len)[:, :, 0]
    bias = (1.0 - chunk_valid.float()) * CHUNK_MASK_BIAS
    per_chunk = torch.einsum("be,bce->bc", q_embs.float(), doc_embs.float())
    return torch.amax(per_chunk + bias, dim=-1)


class DPRBiEncoder(nn.Module):
    """Two independent BERT towers with CLS pooling (models.py:219-262)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.question_model = TransformerEncoder(config.arch)
        self.ctx_model = TransformerEncoder(config.arch)

    def query_emb(self, input_ids, attention_mask):
        return at_least_f32(self.question_model(input_ids, attention_mask)[:, 0])

    def body_emb(self, input_ids, attention_mask):
        return at_least_f32(self.ctx_model(input_ids, attention_mask)[:, 0])

    def forward(self, input_ids, attention_mask, *, is_query: bool = True):
        if is_query:
            return self.query_emb(input_ids, attention_mask)
        return self.body_emb(input_ids, attention_mask)


def build_model(config: ModelConfig) -> nn.Module:
    """Registry config -> module (f32 parameters on the CPU)."""
    if config.two_tower:
        return DPRBiEncoder(config)
    return AnceEncoder(config)
