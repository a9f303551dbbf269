"""CLI: online serving, one turn per replay, with measured latency.

The counterpart of ``convdr_tpu/drivers/serve_online.py``, flag for flag.
The batch driver (``run_convdr_inference``) encodes all queries, then
searches: fine for replaying an evaluation set. A deployed conversational
system serves one turn at a time; this driver builds a resident
:class:`convdr_torch.retrieval.online.OnlineSearcher` (the encoder and the
index search captured as one CUDA graph, model and index resident on the
card), replays the evaluation topics one turn at a time, and reports the
per-turn latency percentiles beside the usual TREC run and metrics. It
runs on the card unless ``--no_cuda`` asks for the CPU (the same program,
eagerly); without a card it raises.

Backends: ``--ann_data_dir`` (a flat resident corpus; ``--storage_dtype``
float32 / bfloat16 / int8) or ``--ivf_dir`` (a resident IVF / IVFPQ probe,
``--nprobe``); exactly one of them.

Output: a ``serving_latency`` JSON line with p50/p90/p99 per-turn
milliseconds (the copies, one replay, the read-back and the id mapping;
the evaluation set is tokenized beforehand through ConvSearchDataset, so
the tokenizer is outside the timed window here, where
``OnlineSearcher.search`` times it in; the capture is a warm-up call,
left out), and the metrics JSON line when ``--qrels`` is given.

``--matmul_precision high/default`` scores the flat backends with a TF32
or a bf16 product on the card (close ranks can swap; int8 ignores it, as
does ``--ivf_dir``). ``--dtype bfloat16`` loads the model with the loader's
default GELU (erf), as the JAX driver does.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from convdr_torch.core.device import resolve_device
from convdr_torch.core.registry import MODEL_REGISTRY
from convdr_torch.data.collection import load_qrels
from convdr_torch.data.conv_dataset import ConvSearchDataset
from convdr_torch.data.token_cache import load_offset2pid
from convdr_torch.evaluation.metrics import evaluate_run, mean_metrics
from convdr_torch.retrieval.online import OnlineSearcher
from convdr_torch.retrieval.run_writer import write_run_outputs

logger = logging.getLogger(__name__)


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--eval_file", type=str, required=True)
    parser.add_argument("--processed_data_dir", type=str, required=True)
    parser.add_argument("--ann_data_dir", type=str, default=None,
                        help="flat resident corpus (embedding blocks)")
    parser.add_argument("--ivf_dir", type=str, default=None,
                        help="resident IVF/IVFPQ index directory")
    parser.add_argument("--qrels", type=str, default=None)
    parser.add_argument("--output_trec_file", type=str, default=None)
    parser.add_argument(
        "--query", default="no_res",
        choices=["no_res", "man_can", "auto_can"],
        help="serving concatenates the session history (the inference "
        "modes that see history; target/output/raw are single-utterance "
        "evaluation modes of the batch driver)",
    )
    parser.add_argument("--model_type", required=True, type=str,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--top_n", default=100, type=int)
    parser.add_argument("--nprobe", default=8, type=int)
    parser.add_argument(
        "--storage_dtype", default="float32",
        choices=["float32", "bfloat16", "int8"],
    )
    parser.add_argument(
        "--matmul_precision", default="highest",
        choices=["highest", "high", "default"],
        help="flat search matmul precision: 'highest' is oracle-bit-exact "
        "(full f32, no TF32); 'high' / 'default' are a TF32 / a bf16 "
        "product on the card (f32 on the CPU)",
    )
    parser.add_argument("--max_concat_length", default=256, type=int)
    parser.add_argument("--max_query_length", default=64, type=int)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--arch_size", default="base",
                        choices=["base", "tiny"])
    parser.add_argument("--no_cuda", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
    return parser.parse_args(argv)


def build_searcher(args, device: torch.device) -> OnlineSearcher:
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    preset = "tiny" if args.arch_size == "tiny" else None
    if (args.ann_data_dir is None) == (args.ivf_dir is None):
        raise ValueError(
            "exactly one of --ann_data_dir (flat) or --ivf_dir (ANN) "
            "selects the resident backend"
        )
    common = dict(model_type=args.model_type, top_n=args.top_n,
                  max_concat_length=args.max_concat_length, dtype=dtype,
                  arch_preset=preset, device=device)
    if args.ivf_dir:
        return OnlineSearcher.from_ivf(args.model_path, args.ivf_dir, nprobe=args.nprobe,
                                       **common)
    return OnlineSearcher.from_blocks(args.model_path, args.ann_data_dir,
                                      storage_dtype=args.storage_dtype,
                                      precision=args.matmul_precision, **common)


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    searcher = build_searcher(args, resolve_device(args.no_cuda))

    dataset = ConvSearchDataset(
        [args.eval_file],
        searcher.tokenizer,
        mode="inference",
        query_mode=args.query,
        model_type=args.model_type,
        max_concat_length=searcher.max_concat_length,
        max_query_length=args.max_query_length,
    )

    logger.info("warm-up call (capture)...")
    searcher.warmup()

    qids, all_s, all_i, raw = [], [], [], {}
    for batch in dataset.batches(1):  # one turn a replay
        s, i = searcher.search_tokens(batch["concat_ids"], batch["concat_mask"])
        qids.extend(batch["qid"])
        all_s.append(s)
        all_i.append(i)
        for qid, seq in zip(batch["qid"], batch["history_utterances"]):
            raw[qid] = seq
    scores = np.concatenate(all_s)
    offsets = np.concatenate(all_i)

    offset2pid = load_offset2pid(args.processed_data_dir)
    qrels = load_qrels(args.qrels) if args.qrels else None
    run = write_run_outputs(
        qids, scores, offsets, offset2pid, args.top_n,
        output_trec_file=args.output_trec_file,
        qrels=qrels,
        raw_sequences=raw,
    )
    latency = searcher.stats.summary()
    print(json.dumps({"serving_latency": latency}))
    logger.info("per-turn latency: %s", latency)
    if qrels:
        per_q = evaluate_run(
            run, qrels, ndcg_cuts=(3,), recall_cuts=(args.top_n,)
        )
        means = mean_metrics(per_q)
        logger.info("metrics over %d judged queries: %s", len(per_q), means)
        print(json.dumps({"num_queries": len(per_q), **means}))
        return {**means, "serving_latency": latency}
    return {"run": run, "serving_latency": latency}


if __name__ == "__main__":
    main()
