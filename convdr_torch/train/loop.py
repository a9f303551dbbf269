"""High-level training loop + 5-fold cross-validation harness.

The counterpart of ``convdr_tpu/train/loop.py``: what the reference's
run_convdr_train.py:41-252 does in its epoch/step loop -- batching, the
train step, metric logging and checkpointing -- and the fold harness of
:255-566: ``cross_validate`` trains fold ``i`` on files
``{train_file}.{j}, j != i`` (NUM_FOLD=5, utils/util.py:32), saving to
``{output_dir}-{i}``.

Data parallel with a ``mesh``: every rank walks the same batches of the
global size ``per_device_batch_size * n_devices`` and samples the same
negatives from ``(seed, micro_step)``, but tokenizes and uploads only its
slice, on which it computes its part of the step
(:func:`~convdr_torch.train.trainer.make_train_step`); the student's and
the teacher's weights are broadcast from the main rank first, and only the
main rank writes checkpoints, ``metrics.jsonl`` and the final model.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from convdr_torch.core.config import NUM_FOLD, TrainConfig
from convdr_torch.data.conv_dataset import ConvSearchDataset
from convdr_torch.parallel.mesh import axis_max, barrier, batch_rows, is_main_rank, replicate
from convdr_torch.train.checkpoint import (
    SAVE_FORMATS,
    latest_checkpoint,
    load_metadata,
    restore_checkpoint,
    save_state,
)
from convdr_torch.train.ranking_data import (
    DocumentTokenizerCache,
    choose_ranking_docs,
    doc_rung,
    encode_ranking_docs,
)
from convdr_torch.train.trainer import create_train_state, make_train_step
from convdr_torch.utils.observability import MetricsLogger

logger = logging.getLogger(__name__)


def _sampling_rng(seed: int, micro_step: int) -> np.random.RandomState:
    """Negative-sampling RNG for one micro-step, derived from
    ``(seed, micro_step)`` so a resumed run draws the SAME negatives at the
    same step as an uninterrupted one (the fast-forward loop consumes no RNG
    state). The same draws as the JAX package's."""
    return np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence((seed, micro_step)))
    )


def _device_batch(batch: Dict, config: TrainConfig, doc_cache, rng,
                  device: torch.device, mesh=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch on its device (all of them
    without a mesh). The negatives are drawn for the whole batch, so every
    rank consumes ``rng`` as one process does, but only this rank's
    documents are tokenized; their length rung is the global batch's
    (the ranks' longest document, one ``all_reduce``)."""
    names = ("concat_ids", "concat_mask", "target_ids", "target_mask")
    rows = batch_rows(mesh, batch[names[0]].shape[0])
    out = {n: torch.from_numpy(batch[n][rows]).to(device) for n in names}
    if config.ranking_task:
        groups = choose_ranking_docs(batch["documents"], config.num_negatives, rng)
        doc_ids, doc_mask = encode_ranking_docs(groups[rows], doc_cache)
        if config.doc_length_buckets:
            longest = int(doc_mask.sum(axis=-1).max())
            if mesh is not None:
                longest = axis_max(mesh, "data", longest, device)
            rung = doc_rung(config.doc_length_buckets, longest, doc_cache.max_doc_length)
            doc_ids, doc_mask = doc_ids[:, :, :rung], doc_mask[:, :, :rung]
        out["doc_ids"] = torch.from_numpy(np.ascontiguousarray(doc_ids)).to(device)
        out["doc_mask"] = torch.from_numpy(np.ascontiguousarray(doc_mask)).to(device)
    return out


def train_one_model(
    dataset: ConvSearchDataset,
    student: nn.Module,
    teacher: nn.Module,
    config: TrainConfig,
    *,
    tokenizer=None,
    output_dir: Optional[str] = None,
    mesh=None,
    metrics: Optional[MetricsLogger] = None,
    fold_id: int = 0,
    n_devices: int = 1,
    resume: bool = False,
    save_format: str = "torch",
):
    """Run the epoch/step loop; returns (student, global_step, avg_loss).

    Every ``save_steps`` optimizer steps the main rank writes
    ``checkpoint-N`` in ``save_format`` (``save_state``: ``"torch"``, the
    port's ``train_state.pt``, or ``"orbax"``, the JAX package's TrainState
    tree).

    ``resume=True`` restores the newest ``checkpoint-N`` under
    ``output_dir``, in either format (parameters, optimizer state, step),
    and continues until the original ``t_total``. Batch order is re-derived from the epoch seed
    and the negative sample from ``(seed, micro_step)``, so a resumed run is
    bit-identical to an uninterrupted one.

    A step takes ``per_device_batch_size * n_devices`` examples; with a
    ``mesh`` (pass ``n_devices`` = its ``data`` size) each rank computes
    ``per_device_batch_size`` of them.
    """
    if save_format not in SAVE_FORMATS:
        raise ValueError(f"save format {save_format!r} is not one of {SAVE_FORMATS}")
    batch_size = config.per_device_batch_size * max(1, n_devices)
    if len(dataset) < batch_size:
        # drop_last: a smaller dataset would yield ZERO batches and the loop
        # would silently no-op through every epoch.
        raise ValueError(
            f"dataset has {len(dataset)} examples but one optimizer step "
            f"needs {batch_size} (per_device_batch_size="
            f"{config.per_device_batch_size} x {max(1, n_devices)} devices); "
            "reduce the batch size or add data"
        )
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    opt_steps_per_epoch = max(steps_per_epoch // config.gradient_accumulation_steps, 1)
    if config.max_steps > 0:
        t_total = config.max_steps
        epochs = config.max_steps // opt_steps_per_epoch + 1
    else:
        epochs = int(np.ceil(config.num_train_epochs))
        # fractional epochs stop mid-epoch at t_total
        t_total = max(int(opt_steps_per_epoch * config.num_train_epochs), 1)

    device = next(student.parameters()).device
    if mesh is not None:
        replicate(mesh, student)
        replicate(mesh, teacher)
    state, tx = create_train_state(student, config, t_total)
    if resume and output_dir:
        ckpt = latest_checkpoint(output_dir)
        if ckpt is not None:
            state = restore_checkpoint(ckpt, state)
            meta = load_metadata(ckpt) or {}
            logger.info("resumed from %s at global step %d", ckpt,
                        int(meta.get("global_step", state.step)))
    step_fn = make_train_step(student, teacher, tx, config, mesh=mesh)
    doc_cache = (
        DocumentTokenizerCache(tokenizer, config.max_doc_length)
        if config.ranking_task else None
    )

    logger.info(
        "***** Running training ***** examples=%d epochs=%d batch=%d total_steps=%d",
        len(dataset), epochs, batch_size, t_total,
    )
    # Metric sums stay on the device and are read only at log boundaries.
    start_micro = state.step  # nonzero after resume
    micro_step = 0
    global_step = start_micro // config.gradient_accumulation_steps
    accum: Dict[str, torch.Tensor] = {}
    n_accum = 0
    total_loss = 0.0
    n_loss_steps = 0
    done = False
    for epoch in range(epochs):
        for batch in dataset.batches(
            batch_size, shuffle=True, seed=config.seed + epoch, drop_last=True
        ):
            if micro_step < start_micro:
                # resumed run: fast-forward past already-trained batches
                micro_step += 1
                continue
            dev_batch = _device_batch(
                batch, config, doc_cache, _sampling_rng(config.seed, micro_step), device, mesh
            )
            state, m = step_fn(state, dev_batch)
            micro_step += 1
            for k, v in m.items():
                accum[k] = accum.get(k, 0.0) + v
            n_accum += 1
            if micro_step % config.gradient_accumulation_steps == 0:
                global_step = micro_step // config.gradient_accumulation_steps
                if config.log_steps > 0 and global_step % config.log_steps == 0:
                    means = {k: float(v) / n_accum for k, v in accum.items()}
                    logger.info("fold %s step %d %s", fold_id, global_step,
                                {k: round(v, 5) for k, v in means.items()})
                    if metrics is not None:
                        metrics.log(global_step, means)
                    total_loss += means.get("loss", 0.0) * n_accum
                    n_loss_steps += n_accum
                    accum, n_accum = {}, 0
                if output_dir and config.save_steps > 0 and global_step % config.save_steps == 0:
                    ckpt = os.path.join(output_dir, f"checkpoint-{global_step}")
                    if is_main_rank(mesh):
                        save_state(ckpt, state, save_format, config.weight_decay,
                                   metadata={"global_step": global_step})
                        logger.info("Saved checkpoint %s", ckpt)
                    barrier(mesh)
            if config.max_steps > 0 and global_step >= config.max_steps:
                done = True
                break
            if global_step >= t_total:
                done = True  # stop at the schedule's budget
                break
        if done:
            break

    if n_accum:
        total_loss += float(accum.get("loss", 0.0))
        n_loss_steps += n_accum
    avg = total_loss / max(n_loss_steps, 1)
    return state.model, global_step, avg


def run_training(
    *,
    train_file: str,
    load_student: Callable[[Optional[int]], tuple],
    teacher: nn.Module,
    config: TrainConfig,
    query_mode: str,
    model_type: str,
    output_dir: str,
    cross_validate: bool = False,
    init_from_multiple_models: bool = False,
    mesh=None,
    n_devices: int = 1,
    save_fn: Optional[Callable] = None,
    resume: bool = False,
    save_format: str = "torch",
) -> List[str]:
    """Train once or per fold. ``load_student(fold)`` -> (tokenizer,
    student); ``save_fn(student, out_dir, tokenizer)`` persists the final
    model (default: ``<out_dir>/final`` in ``save_format``). Returns the
    list of output dirs written. ``mesh``, ``n_devices`` and
    ``save_format`` as in :func:`train_one_model`; only the main rank
    writes."""
    outputs = []
    folds = range(NUM_FOLD) if cross_validate else [None]
    writer = is_main_rank(mesh)
    metrics = MetricsLogger(output_dir) if writer else None
    for fold in folds:
        fold_id = -1 if fold is None else fold
        tokenizer, student = load_student(
            fold if (fold is not None and init_from_multiple_models) else None
        )
        if fold is None:
            files = [train_file]
            out_dir = output_dir
        else:
            files = [f"{train_file}.{j}" for j in range(NUM_FOLD) if j != fold]
            out_dir = f"{output_dir}-{fold}"
            logger.info("Training Fold #%d on %s", fold, files)
        dataset = ConvSearchDataset(
            files, tokenizer, mode="train", query_mode=query_mode,
            model_type=model_type, max_concat_length=config.max_concat_length,
            max_query_length=config.max_query_length,
            ranking_task=config.ranking_task,
        )
        student, global_step, avg_loss = train_one_model(
            dataset, student, teacher, config, tokenizer=tokenizer,
            output_dir=out_dir, mesh=mesh, metrics=metrics, fold_id=fold_id,
            n_devices=n_devices, resume=resume, save_format=save_format,
        )
        logger.info("fold %s: global_step=%d avg_loss=%.5f", fold_id, global_step, avg_loss)
        if writer:
            os.makedirs(out_dir, exist_ok=True)
            if save_fn is not None:
                save_fn(student, out_dir, tokenizer)
            else:
                save_state(
                    os.path.join(out_dir, "final"), student, save_format,
                    metadata={"model_type": model_type, "global_step": global_step},
                )
        barrier(mesh)
        outputs.append(out_dir)
    if writer:
        metrics.close()
    return outputs
