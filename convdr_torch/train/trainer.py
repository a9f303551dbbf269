"""KD + ranking training step: student encode, frozen teacher, MSE + ranking
NLL, clipped AdamW.

The counterpart of ``convdr_tpu/train/trainer.py`` (reference
run_convdr_train.py:41-252). The student's attention runs forward and
backward through the flash kernels (``models/attention.py``); the teacher
runs under ``torch.no_grad()`` in ``eval()`` mode, which is what
``stop_gradient`` on frozen parameters does in the JAX step. Documents
arrive tokenized and sampled by the input pipeline (``ranking_data.py``) as
``doc_ids/doc_mask [B, 1+num_negatives, L]``. Eager PyTorch has no ``jit``:
one call runs the step.

With a ``mesh`` the step is data parallel over ``data_axis``, as the JAX
step with a batch sharded over it and replicated parameters: each rank
passes its contiguous slice of the global batch (``shard_batch``, or the
training loop's own slice), and one ``all_reduce`` of the flattened gradients (divided by the axis size) gives
every rank the gradient of the global batch's loss, since each loss is a
mean over equal slices. The loss metrics are averaged the same way, the
global norm is taken after, and every rank applies the same update, so the
parameters stay replicated. On one rank the step's arithmetic is the
unmeshed step's, bit for bit.

In bf16 the student computes in bf16 over f32 master parameters
(``load_model_and_params(..., f32_params=True)``): its gradients, their
norm and the clipped AdamW update are f32, as in the JAX package.
``use_dropout`` gives the student's dropout sites a ``torch.Generator``
seeded from ``(config.seed, step)`` for one step, after the JAX step's
``fold_in(PRNGKey(seed), step)``, and under a mesh from ``(config.seed,
step, rank)``: the same seed repeats a run (torch draws other bits than
JAX). Without it no site drops, though the step puts the student in
``train()`` mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from convdr_torch.core.config import TrainConfig
from convdr_torch.core.loading import make_apply_fn
from convdr_torch.models.transformer import set_dropout_generator
from convdr_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    sharded_apply,
)
from convdr_torch.train.losses import (
    kd_mse_loss,
    ranking_nll_loss,
    ranking_nll_multichunk_loss,
)
from convdr_torch.train.optimizer import ClipAdamW, global_norm, make_optimizer


@dataclasses.dataclass
class TrainState:
    """The student (its parameters), the optimizer state and the number of
    micro-steps taken."""

    model: nn.Module
    opt_state: dict
    step: int = 0


def create_train_state(
    model: nn.Module, config: TrainConfig, total_steps: int
) -> Tuple[TrainState, ClipAdamW]:
    tx = make_optimizer(config, total_steps, model)
    return TrainState(model=model, opt_state=tx.init(dict(model.named_parameters()))), tx


def dropout_generator(seed: int, step: int, device: torch.device,
                      rank: Optional[int] = None) -> torch.Generator:
    """The dropout stream of one micro-step, from ``(seed, step)`` (the JAX
    step's ``fold_in(PRNGKey(seed), step)``), or ``(seed, step, rank)`` for
    one rank of a data-parallel step, apart from the negative sampling's
    ``SeedSequence((seed, step))`` by its spawn key."""
    entropy = (seed, step) if rank is None else (seed, step, rank)
    state = np.random.SeedSequence(entropy, spawn_key=(1,)).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]))


def _mean_over_axis(mesh, axis: str, tensors):
    """Replace each tensor by its mean over the ``axis`` ranks, in place,
    through one ``all_reduce`` of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axis_group(mesh, axis))
    flat /= axis_size(mesh, axis)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def make_train_step(student: nn.Module, teacher: nn.Module, tx: ClipAdamW,
                    config: TrainConfig, *, mesh=None,
                    data_axis: str = "data") -> Callable:
    """Build the train step ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``concat_ids/concat_mask/target_ids/target_mask`` and,
    for the ranking task, ``doc_ids/doc_mask [B, K, L]``, all tensors on the
    student's device. ``state.model`` is ``student``. Metrics (0-dim
    tensors): ``loss``, ``mse_loss`` and/or ``ranking_loss``, and
    ``grad_norm``, the global norm of this micro-step's gradients. After the
    step each parameter's ``.grad`` holds those gradients.

    With a ``mesh`` each rank passes its slice of the global batch
    (:func:`~convdr_torch.parallel.mesh.shard_batch` along ``data_axis``,
    every slice of one height) and the metrics and gradients are the
    global batch's.
    """
    student_apply = make_apply_fn(student, grad=True)
    use_mse = not config.no_mse
    use_ranking = config.ranking_task
    rank = None if mesh is None else axis_index(mesh, data_axis)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.train()
        teacher.eval()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if config.use_dropout:
            set_dropout_generator(model, dropout_generator(
                config.seed, state.step, batch["concat_ids"].device, rank))
        try:
            embs = student_apply(batch["concat_ids"], batch["concat_mask"], True)
        finally:
            set_dropout_generator(model, None)
        metrics: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=embs.device)
        if use_mse:
            with torch.no_grad():
                teacher_embs = teacher.query_emb(batch["target_ids"], batch["target_mask"])
            mse = kd_mse_loss(embs, teacher_embs)
            loss = loss + mse
            metrics["mse_loss"] = mse.detach()
        if use_ranking:
            b, k, length = batch["doc_ids"].shape
            with torch.no_grad():
                doc_embs = teacher.body_emb(
                    batch["doc_ids"].reshape(b * k, length),
                    batch["doc_mask"].reshape(b * k, length),
                )
            if doc_embs.dim() == 3:
                # multi-chunk teacher: [B*K, C, E] -> max-over-chunk scores
                # (NLL_MultiChunk semantics, models.py:100-118)
                c = doc_embs.shape[1]
                rank_loss = ranking_nll_multichunk_loss(
                    embs, doc_embs.reshape(b, k, c, -1), batch["doc_mask"],
                    length // c,
                )
            else:
                rank_loss = ranking_nll_loss(embs, doc_embs.reshape(b, k, -1))
            loss = loss + rank_loss
            metrics["ranking_loss"] = rank_loss.detach()
        metrics["loss"] = loss.detach()
        loss.backward()
        grads = {
            n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()
        }
        if mesh is not None:
            _mean_over_axis(mesh, data_axis, list(grads.values()))
            names = sorted(metrics)
            values = torch.stack([metrics[n] for n in names])
            _mean_over_axis(mesh, data_axis, [values])
            metrics = dict(zip(names, values.unbind()))
        metrics["grad_norm"] = global_norm(grads.values())
        tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    return step


def make_query_encode_fn(model: nn.Module, *, mesh=None,
                         data_axis: str = "data") -> Callable:
    """Inference-time query encoder (reference evaluate(), inference.py:116-154):
    ``encode(ids, mask) -> [B, E]`` without autograd; with a ``mesh``,
    data parallel over ``data_axis`` (every rank passes the same batch and
    gets all of its rows)."""
    apply_fn = make_apply_fn(model)

    def encode_rows(ids, mask):
        return apply_fn(ids, mask, True)

    if mesh is None:
        return encode_rows
    return lambda ids, mask: sharded_apply(mesh, data_axis, encode_rows, ids, mask)
