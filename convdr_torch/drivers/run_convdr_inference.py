"""CLI: ConvDR retrieval inference + evaluation.

The counterpart of ``convdr_tpu/drivers/run_convdr_inference.py``, flag for
flag (reference run_convdr_inference.py:245-320: --model_path, --eval_file,
--ann_data_dir, --qrels, --processed_data_dir, --raw_data_dir,
--output_file, --output_trec_file, --query, --output_query_type, --fold,
--model_type, --top_n, --cross_validate). The query encoder and the exact
flat search run on the card unless ``--no_cuda`` asks for the CPU; without
a card it raises. NDCG@3 / MRR / recall@top_n are computed in-process and
printed as one JSON line.

``--storage_dtype int8`` searches SQ8 blocks (or quantizes float blocks on
the device) with the scales of the blocks' ``int8_scales.npy`` sidecar;
``--rescore_factor N`` with int8 or bfloat16 storage re-ranks each block's
top ``N * top_n`` with full-precision scores from float block files, and
exits with an error with float32 storage, whose flat search is exact
already.

Not ported yet (they raise, see ROADMAP.md): ``--ivf_dir``, ``--pq_dir``,
``--matmul_precision high/default`` and ``--profile_dir``. ``--no_mesh``
and ``--use_gpu`` are accepted; this package runs on one device.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from convdr_torch.core.config import NOT_PORTED, NUM_FOLD, SearchConfig
from convdr_torch.core.device import resolve_device
from convdr_torch.core.loading import (
    gelu_arch_overrides,
    load_model_and_params,
    make_apply_fn,
)
from convdr_torch.core.registry import MODEL_REGISTRY
from convdr_torch.data.collection import (
    find_collection,
    load_collection,
    load_qrels,
    load_queries_tsv,
)
from convdr_torch.data.conv_dataset import ConvSearchDataset
from convdr_torch.data.token_cache import load_offset2pid
from convdr_torch.evaluation.metrics import evaluate_run, mean_metrics
from convdr_torch.retrieval.run_writer import write_run_outputs
from convdr_torch.retrieval.searcher import BlockedSearcher

logger = logging.getLogger(__name__)


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--eval_file", type=str, required=True)
    parser.add_argument("--max_concat_length", default=256, type=int)
    parser.add_argument("--max_query_length", default=64, type=int)
    parser.add_argument("--cross_validate", action="store_true")
    parser.add_argument("--per_gpu_eval_batch_size", default=4, type=int)
    parser.add_argument("--no_cuda", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--cache_dir", type=str, default=None)
    parser.add_argument("--ann_data_dir", type=str, required=True)
    parser.add_argument("--use_gpu", action="store_true")  # accepted, unused
    parser.add_argument("--qrels", type=str, default=None)
    parser.add_argument("--processed_data_dir", type=str, required=True)
    parser.add_argument("--raw_data_dir", type=str, required=True)
    parser.add_argument("--output_file", type=str, default=None)
    parser.add_argument("--output_trec_file", type=str, default=None)
    parser.add_argument(
        "--query", default="no_res",
        choices=["no_res", "man_can", "auto_can", "target", "output", "raw"],
    )
    parser.add_argument("--output_query_type", type=str, required=True)
    parser.add_argument("--fold", type=int, default=-1)
    parser.add_argument("--model_type", required=True, type=str,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--top_n", default=100, type=int)
    parser.add_argument(
        "--storage_dtype", default="float32",
        choices=["float32", "bfloat16", "int8"],
        help="device dtype for embedding blocks during search (match the "
        "gen_passage_embeddings --storage_dtype; f32 accumulation either "
        "way); bfloat16 is a cast on upload. int8 = SQ8 scalar quantization "
        "(quarter the device memory; scales come from the blocks' "
        "int8_scales.npy sidecar)",
    )
    parser.add_argument(
        "--rescore_factor", default=0, type=int,
        help="re-rank the top (rescore_factor * top_n) approximate "
        "candidates of each block with full-precision scores before the "
        "final cut (FAISS IndexRefineFlat's k_factor); works with "
        "--storage_dtype int8/bfloat16 over float block files. 0 = off. "
        "Errors with float32 flat search (exact already)",
    )
    parser.add_argument(
        "--matmul_precision", default="highest",
        choices=["highest", "high", "default"],
        help="search matmul precision; only 'highest' (oracle-bit-exact, "
        "no TF32) is ported",
    )
    parser.add_argument(
        "--max_device_block_bytes", type=int,
        default=SearchConfig.max_device_block_bytes,
        help="Device-side capacity cap: on-disk embedding blocks above "
        "this many bytes are searched as sequential sub-blocks (results "
        "bit-identical)",
    )
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--gelu", default="auto",
                        choices=["auto", "erf", "tanh"],
                        help="GELU flavor; auto = tanh under bf16 (inside "
                        "bf16 noise), erf under f32")
    parser.add_argument("--arch_size", default="base", choices=["base", "tiny"],
                        help="tiny = miniature architecture for smoke tests")
    parser.add_argument("--ivf_dir", type=str, default="",
                        help="IVF search; not ported yet")
    parser.add_argument("--nprobe", type=int, default=32,
                        help="IVF only; accepted")
    parser.add_argument("--pq_dir", type=str, default="",
                        help="PQ search; not ported yet")
    parser.add_argument("--no_mesh", action="store_true",
                        help="accepted; this package runs on one device")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="search-phase trace; not ported yet")
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Raise on the options of the JAX driver this package lacks, and exit,
    as the JAX driver does, on a rescore that has nothing to refine."""
    unported = [
        ("--ivf_dir", bool(args.ivf_dir)),
        ("--pq_dir", bool(args.pq_dir)),
        (f"--matmul_precision {args.matmul_precision}",
         args.matmul_precision != "highest"),
        ("--profile_dir", bool(args.profile_dir)),
    ]
    for flag, used in unported:
        if used:
            raise NotImplementedError(f"{flag} {NOT_PORTED}")
    if args.rescore_factor > 0 and args.storage_dtype == "float32":
        raise SystemExit(
            "--rescore_factor refines approximate candidates; the float32 "
            "flat search is already exact. Combine it with --storage_dtype "
            "int8/bfloat16"
        )


def encode_queries(args, model_path, eval_file, dtype, device):
    """Load a model and embed all eval queries (reference evaluate(),
    :116-154). Returns (qids, [Q, E] f32 embeddings, raw sequences)."""
    preset = "tiny" if args.arch_size == "tiny" else None
    _cfg, tokenizer, model = load_model_and_params(
        args.model_type, model_path, device=device, dtype=dtype,
        arch_preset=preset,
        arch_overrides=gelu_arch_overrides(args.gelu, args.dtype),
    )
    # reference clamp (run_convdr_inference.py:395-398): concat length may
    # not exceed what the position-embedding table supports (past it, an
    # embedding lookup is a device-side assert on CUDA)
    if args.max_concat_length <= 0:
        args.max_concat_length = tokenizer.max_len_single_sentence
    args.max_concat_length = min(
        args.max_concat_length, tokenizer.max_len_single_sentence
    )
    dataset = ConvSearchDataset(
        [eval_file],
        tokenizer,
        mode="inference",
        query_mode=args.query,
        model_type=args.model_type,
        max_concat_length=args.max_concat_length,
        max_query_length=args.max_query_length,
    )
    encode = make_apply_fn(model)
    qids, embs, raw = [], [], {}
    for batch in dataset.batches(args.per_gpu_eval_batch_size):
        ids = torch.from_numpy(batch["concat_ids"]).to(device)
        mask = torch.from_numpy(batch["concat_mask"]).to(device)
        embs.append(encode(ids, mask, True).cpu().numpy())
        qids.extend(batch["qid"])
        for qid, seq in zip(batch["qid"], batch["history_utterances"]):
            raw[qid] = seq
    return qids, np.concatenate(embs, axis=0), raw


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    check_ported(args)
    device = resolve_device(args.no_cuda)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    offset2pid = load_offset2pid(args.processed_data_dir)
    qrels = load_qrels(args.qrels) if args.qrels else {}

    all_qids, all_embs, all_raw = [], [], {}
    if not args.cross_validate:
        qids, embs, raw = encode_queries(
            args, args.model_path, args.eval_file, dtype, device
        )
        all_qids, all_raw = qids, raw
        all_embs = [embs]
    else:
        for fold in range(NUM_FOLD):
            if args.fold != -1 and fold != args.fold:
                continue
            logger.info("Testing Fold #%d", fold)
            qids, embs, raw = encode_queries(
                args,
                f"{args.model_path}-{fold}",
                f"{args.eval_file}.{fold}",
                dtype,
                device,
            )
            all_qids.extend(qids)
            all_embs.append(embs)
            all_raw.update(raw)
    query_embs = np.concatenate(all_embs, axis=0)

    searcher = BlockedSearcher(
        SearchConfig(
            storage_dtype=args.storage_dtype,
            max_device_block_bytes=args.max_device_block_bytes,
            rescore_factor=args.rescore_factor,
        ),
        device=device,
    )
    scores, offsets = searcher.search_blocks(
        args.ann_data_dir, query_embs, args.top_n
    )

    queries = load_queries_tsv(
        os.path.join(args.raw_data_dir, f"queries.{args.output_query_type}.tsv")
    )
    collection = (
        load_collection(find_collection(args.raw_data_dir))
        if args.output_file
        else None
    )
    run = write_run_outputs(
        all_qids, scores, offsets, offset2pid, args.top_n,
        output_trec_file=args.output_trec_file,
        output_file=args.output_file,
        queries=queries,
        collection=collection,
        qrels=qrels,
        raw_sequences=all_raw,
    )
    if qrels:
        per_q = evaluate_run(
            run, qrels, ndcg_cuts=(3,), recall_cuts=(args.top_n,)
        )
        means = mean_metrics(per_q)
        logger.info("metrics over %d judged queries: %s", len(per_q), means)
        print(json.dumps({"num_queries": len(per_q), **means}))
        return means
    return run


if __name__ == "__main__":
    main()
