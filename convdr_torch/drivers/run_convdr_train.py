"""CLI: ConvDR knowledge-distillation (+ ranking) training.

The counterpart of ``convdr_tpu/drivers/run_convdr_train.py``, flag for flag
(reference run_convdr_train.py:255-435: --output_dir, --train_file,
--model_type, the query modes, ranking/no_mse switches, LR/clip/
accumulation/save/log knobs and the --cross_validate /
--init_from_multiple_models fold harness). Training runs on the card
unless ``--no_cuda`` asks for the CPU; without a card it raises. Scalars go
to ``metrics.jsonl`` in the output dir, checkpoints are ``checkpoint-N``
dirs (:mod:`convdr_torch.train.checkpoint`), and the trained student is
written as ``pytorch_model.bin`` in the reference's HF layout plus its
tokenizer, which ``load_model_and_params`` (so ``run_convdr_inference``)
reads.

``--dtype bfloat16`` computes in bf16 over f32 master weights: the teacher
is cast to bf16 for its frozen forwards, the student keeps f32 parameters
cast where they are used (``load_model_and_params(f32_params=True)``), and
the optimizer and the checkpoints hold the f32 masters, which reload for
bf16 inference. ``--use_dropout`` trains with the student's dropout active
(seeded from ``--seed`` and the step, and the rank under a mesh).

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the ranks train one
student data parallel over a ``("data",)`` mesh, unless ``--no_mesh``: a
step takes ``--per_gpu_train_batch_size`` examples a rank, and only rank 0
writes checkpoints, metrics and the model.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from convdr_torch.core.config import TrainConfig
from convdr_torch.core.loading import gelu_arch_overrides, load_model_and_params
from convdr_torch.core.registry import MODEL_REGISTRY
from convdr_torch.data.conv_dataset import RESPONSE_TOKEN
from convdr_torch.parallel.mesh import axis_size, barrier, driver_mesh
from convdr_torch.retrieval.embed_corpus import default_length_buckets
from convdr_torch.train.loop import run_training

logger = logging.getLogger(__name__)


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--model_name_or_path", type=str, default=None)
    parser.add_argument("--max_concat_length", default=256, type=int)
    parser.add_argument("--max_query_length", default=64, type=int)
    parser.add_argument("--max_doc_length", default=512, type=int,
                        help="ranking-doc token budget (the reference "
                        "hardcodes 512, run_convdr_train.py:131-137); "
                        "multi-chunk models round it to a chunk multiple")
    parser.add_argument("--train_file", required=True, type=str)
    parser.add_argument("--cross_validate", action="store_true")
    parser.add_argument("--init_from_multiple_models", action="store_true")
    parser.add_argument("--model_type", required=True, type=str,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--ranking_task", action="store_true")
    parser.add_argument("--no_mse", action="store_true")
    parser.add_argument("--num_negatives", default=9, type=int)
    parser.add_argument("--per_gpu_train_batch_size", default=4, type=int)
    parser.add_argument("--gradient_accumulation_steps", default=1, type=int)
    parser.add_argument("--learning_rate", default=1e-5, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--adam_epsilon", default=1e-8, type=float)
    parser.add_argument("--max_grad_norm", default=1.0, type=float)
    parser.add_argument("--num_train_epochs", default=1.0, type=float)
    parser.add_argument("--max_steps", default=-1, type=int)
    parser.add_argument("--warmup_steps", default=0, type=int)
    parser.add_argument("--save_steps", default=-1, type=int)
    parser.add_argument("--no_cuda", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
    parser.add_argument("--overwrite_output_dir", action="store_true")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--log_steps", default=1, type=int)
    parser.add_argument("--cache_dir", type=str, default=None)
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument(
        "--query", default="no_res",
        choices=["no_res", "man_can", "auto_can", "target", "output", "raw"],
    )
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype; bfloat16 keeps f32 master weights")
    parser.add_argument("--doc_length_buckets", default="auto",
                        choices=["auto", "none"],
                        help="trim each ranking-doc batch to the smallest "
                        "64/128/256/384/512 rung covering its longest doc "
                        "(same embeddings, far fewer doc-encode operations); "
                        "'none' keeps fixed max_doc_length")
    parser.add_argument("--gelu", default="auto",
                        choices=["auto", "erf", "tanh"],
                        help="GELU flavor; auto = tanh under bf16, erf under f32")
    parser.add_argument("--export_torch", action="store_true",
                        help="accepted and changes nothing: the trained model "
                        "is always written in the reference HF format "
                        "(pytorch_model.bin)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest checkpoint-N in output_dir")
    parser.add_argument("--use_dropout", action="store_true",
                        help="train with the student's dropout active")
    parser.add_argument("--arch_size", default="base", choices=["base", "tiny"],
                        help="tiny = miniature architecture for smoke tests")
    parser.add_argument("--no_mesh", action="store_true",
                        help="under torchrun, train on each rank alone "
                        "instead of over a data-parallel mesh")
    return parser.parse_args(argv)


def clamp_lengths(config: TrainConfig, t_config, model_type: str) -> TrainConfig:
    """The JAX driver's capacity clamps (run_convdr_train.py:166-217): no
    valid token may land past the position table (on the card that is a
    device-side assert, in JAX a silent NaN)."""
    max_single = t_config.arch.max_position_embeddings - t_config.arch.position_offset
    # reference clamp (run_convdr_train.py:475-478)
    clamped_concat = min(
        config.max_concat_length if config.max_concat_length > 0 else max_single,
        max_single,
    )
    if clamped_concat != config.max_concat_length:
        config = dataclasses.replace(config, max_concat_length=clamped_concat)
    # Multi-chunk models encode each chunk_len-wide chunk as its own
    # sequence, so capacity binds per chunk; the doc budget must instead be
    # a chunk multiple or body_emb's reshape is malformed.
    if MODEL_REGISTRY[model_type].multi_chunk:
        chunk = t_config.chunk_len
        if chunk > max_single:
            raise ValueError(f"chunk_len {chunk} exceeds position capacity {max_single}")
        rounded = max(chunk, (config.max_doc_length // chunk) * chunk)
        if rounded != config.max_doc_length:
            logger.warning(
                "rounding max_doc_length %d to chunk multiple %d (chunk_len=%d)",
                config.max_doc_length, rounded, chunk,
            )
            config = dataclasses.replace(config, max_doc_length=rounded)
    elif config.max_doc_length > max_single:
        logger.warning(
            "clamping max_doc_length %d to position capacity %d",
            config.max_doc_length, max_single,
        )
        config = dataclasses.replace(
            config,
            max_doc_length=max_single,
            doc_length_buckets=(
                tuple(r for r in config.doc_length_buckets if r < max_single)
                + (max_single,)
                if config.doc_length_buckets else None
            ),
        )
    return config


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    with driver_mesh(("data",), no_mesh=args.no_mesh, no_cuda=args.no_cuda) as (mesh, device):
        return train(args, mesh, device)


def train(args, mesh, device):
    dtype = getattr(torch, args.dtype)

    if (
        os.path.exists(args.output_dir)
        and os.listdir(args.output_dir)
        and not args.overwrite_output_dir
        and not args.resume
    ):
        raise ValueError(
            f"Output directory ({args.output_dir}) already exists and is not "
            "empty. Use --overwrite_output_dir to overcome."
        )
    barrier(mesh)  # every rank has looked before rank 0 writes there

    np.random.seed(args.seed)
    config = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        warmup_steps=args.warmup_steps,
        num_train_epochs=args.num_train_epochs,
        max_steps=args.max_steps,
        per_device_batch_size=args.per_gpu_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_negatives=args.num_negatives,
        ranking_task=args.ranking_task,
        no_mse=args.no_mse,
        max_doc_length=args.max_doc_length,
        max_concat_length=args.max_concat_length,
        max_query_length=args.max_query_length,
        seed=args.seed,
        log_steps=args.log_steps,
        save_steps=args.save_steps,
        use_dropout=args.use_dropout,
    )
    # Ranking-doc length rungs: the corpus-embed ladder. Not for multi-chunk
    # models, whose body_emb reshapes docs into chunk_len-wide chunks.
    if (
        args.ranking_task
        and args.doc_length_buckets == "auto"
        and not MODEL_REGISTRY[args.model_type].multi_chunk
    ):
        config = dataclasses.replace(
            config, doc_length_buckets=default_length_buckets(config.max_doc_length)
        )

    preset = "tiny" if args.arch_size == "tiny" else None
    teacher_path = args.teacher_model or args.model_name_or_path
    gelu_overrides = gelu_arch_overrides(args.gelu, args.dtype)
    t_config, _t_tok, teacher = load_model_and_params(
        args.model_type, teacher_path, device=device, dtype=dtype, arch_preset=preset,
        arch_overrides=gelu_overrides,
    )
    teacher.requires_grad_(False)
    config = clamp_lengths(config, t_config, args.model_type)

    extra_tokens = (RESPONSE_TOKEN,) if args.query in ("man_can", "auto_can") else ()

    def load_student(fold):
        path = args.model_name_or_path
        if fold is not None:
            path = f"{path}-{fold}"
        _s_config, s_tok, student = load_model_and_params(
            args.model_type, path, device=device, dtype=dtype, f32_params=True,
            extra_tokens=extra_tokens, seed=args.seed, arch_preset=preset,
            arch_overrides=gelu_overrides,
        )
        return s_tok, student

    def save_fn(student, out_dir, tokenizer):
        state = {k: v.detach().float().cpu() for k, v in student.state_dict().items()}
        torch.save(state, os.path.join(out_dir, "pytorch_model.bin"))
        tokenizer.save_pretrained(out_dir)

    outputs = run_training(
        train_file=args.train_file,
        load_student=load_student,
        teacher=teacher,
        config=config,
        query_mode=args.query,
        model_type=args.model_type,
        output_dir=args.output_dir,
        cross_validate=args.cross_validate,
        init_from_multiple_models=args.init_from_multiple_models,
        mesh=mesh,
        n_devices=1 if mesh is None else axis_size(mesh, "data"),
        save_fn=save_fn,
        resume=args.resume,
    )
    logger.info("training complete: %s", outputs)
    return outputs


if __name__ == "__main__":
    main()
