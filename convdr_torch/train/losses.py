"""Training losses: KD MSE, ranking NLL, in-batch pairwise NLL.

The counterpart of ``convdr_tpu/train/losses.py`` (reference loss heads):

  * :func:`kd_mse_loss`      -- ``MSELoss`` between the student's session
    embedding and the frozen teacher's manual-query embedding
    (run_convdr_train.py:109-115,460).
  * :func:`ranking_nll_loss` -- dot-product logits over [positive,
    negatives] with ``CrossEntropyLoss`` at label 0
    (run_convdr_train.py:162-170).
  * :func:`in_batch_nll_loss` -- the ANCE ``NLL.forward`` pairwise loss
    (model/models.py:52-75): softmax over (q.pos, q.neg), -log p(pos).

Teacher and document embeddings are detached, as ``stop_gradient`` does in
the JAX package.
"""

from __future__ import annotations

import torch

from convdr_torch.models.attention import at_least_f32
from convdr_torch.models.encoders import multi_chunk_scores


def kd_mse_loss(student_embs: torch.Tensor, teacher_embs: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements (torch MSELoss 'mean')."""
    return torch.mean(torch.square(student_embs - teacher_embs.detach()))


def ranking_nll_loss(query_embs: torch.Tensor, doc_embs: torch.Tensor) -> torch.Tensor:
    """query_embs [B, E], doc_embs [B, K, E] with the positive at k=0.

    logits[b, k] = q_b . d_bk ; loss = mean_b CE(logits_b, 0).
    """
    logits = torch.einsum("be,bke->bk", at_least_f32(query_embs),
                          at_least_f32(doc_embs.detach()))
    return -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])


def _pairwise_nll(s_pos: torch.Tensor, s_neg: torch.Tensor) -> torch.Tensor:
    logits = torch.stack([s_pos, s_neg], dim=1)
    return -torch.mean(torch.log_softmax(logits, dim=1)[:, 0])


def in_batch_nll_loss(q_embs, pos_embs, neg_embs) -> torch.Tensor:
    """Pairwise (pos, neg) NLL: -log softmax([q.pos, q.neg])[0], averaged."""
    return _pairwise_nll(
        torch.sum(q_embs * pos_embs, dim=-1), torch.sum(q_embs * neg_embs, dim=-1)
    )


def in_batch_nll_multichunk_loss(
    q_embs, pos_embs, pos_mask, neg_embs, neg_mask, chunk_len: int
) -> torch.Tensor:
    """Multi-chunk pairwise NLL (``NLL_MultiChunk.forward``, models.py:78-126).

    Document embeddings are [B, C, E] chunk matrices with [B, C*L] token
    masks; each document scores as the max chunk inner product with a -9999
    bias on empty chunks (models.py:100-118), then the pairwise NLL.
    """
    return _pairwise_nll(
        multi_chunk_scores(q_embs, pos_embs, pos_mask, chunk_len),
        multi_chunk_scores(q_embs, neg_embs, neg_mask, chunk_len),
    )


def ranking_nll_multichunk_loss(
    query_embs: torch.Tensor, doc_embs: torch.Tensor, doc_mask: torch.Tensor,
    chunk_len: int,
) -> torch.Tensor:
    """Ranking CE with multi-chunk documents (positive at k=0).

    query_embs [B, E]; doc_embs [B, K, C, E]; doc_mask [B, K, C*L]. Each
    document scores as the max chunk inner product with the -9999 empty-
    chunk bias, then the ranking task's CE with label 0.
    """
    b, k, c, e = doc_embs.shape
    q_rep = torch.repeat_interleave(query_embs, k, dim=0)  # [B*K, E]
    scores = multi_chunk_scores(
        q_rep, doc_embs.detach().reshape(b * k, c, e),
        doc_mask.reshape(b * k, -1), chunk_len,
    ).reshape(b, k)
    return -torch.mean(torch.log_softmax(scores, dim=-1)[:, 0])
