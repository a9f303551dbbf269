"""CLI: ConvDR retrieval inference + evaluation.

The counterpart of ``convdr_tpu/drivers/run_convdr_inference.py``, flag for
flag (reference run_convdr_inference.py:245-320: --model_path, --eval_file,
--ann_data_dir, --qrels, --processed_data_dir, --raw_data_dir,
--output_file, --output_trec_file, --query, --output_query_type, --fold,
--model_type, --top_n, --cross_validate). The query encoder and the exact
flat search run on the card unless ``--no_cuda`` asks for the CPU; without
a card it raises. NDCG@3 / MRR / recall@top_n are computed in-process and
printed as one JSON line.

Blocks are read as they were written (f32, bf16 or int8 rows; pickle pairs
or ``.cnb`` files). ``--storage_dtype int8`` searches SQ8 blocks (or
quantizes float blocks on the device) with the scales of the blocks'
``int8_scales.npy`` sidecar;
``--rescore_factor N`` with int8 or bfloat16 storage re-ranks each block's
top ``N * top_n`` with full-precision scores from float block files, and
exits with an error with float32 flat search, which is exact already.

``--ivf_dir`` / ``--pq_dir`` (mutually exclusive) search a prebuilt index
(``convdr_torch.drivers.build_ivf_index``, or the JAX package's) instead
of streaming the blocks: IVF probes ``--nprobe`` sub-lists per query, PQ
scans the ADC codes resident on the card. With ``--rescore_factor N`` the
index proposes ``N * top_n`` candidates (IVF: its rowids; PQ: the ADC
scan's row positions) and the refine store re-ranks them against the rows
of ``--ann_data_dir`` (:mod:`convdr_torch.retrieval.refine`).

The search is timed as the "search" phase (logged, to the end of its
device work), and ``--profile_dir`` writes a ``torch.profiler`` Chrome
trace of it (host and CUDA activity, the phase's ``convdr.phase.search``
span inside) into that directory; without the flag no profiler runs.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the ranks form an
``("index",)`` mesh, unless ``--no_mesh``: the query encode is data
parallel over it, and the flat, ``--ivf_dir`` and ``--pq_dir`` searches
shard the passage rows, sub-lists or codes over it. Only rank 0 writes the
TREC run and the OpenMatch file and prints the metrics; both files are
byte-identical to one process's.

``--matmul_precision high/default`` scores the flat search with a TF32 or
a bf16 product on the card (full f32 on the CPU, as in the JAX package);
the run then agrees with the exact one on most of each top-N, not rank
for rank. ``--use_gpu`` is accepted.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from convdr_torch.core.config import NUM_FOLD, SearchConfig
from convdr_torch.core.loading import (
    gelu_arch_overrides,
    load_model_and_params,
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
from convdr_torch.parallel.mesh import barrier, driver_mesh, is_main_rank
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_torch.retrieval.run_writer import write_run_outputs
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_torch.train.trainer import make_query_encode_fn
from convdr_torch.utils.observability import PhaseTimer, profile_trace

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
        "way); bfloat16 is a cast on upload of float32 files, or bf16 block "
        "files as written. int8 = SQ8 scalar quantization "
        "(quarter the device memory; scales come from the blocks' "
        "int8_scales.npy sidecar)",
    )
    parser.add_argument(
        "--rescore_factor", default=0, type=int,
        help="re-rank the top (rescore_factor * top_n) approximate "
        "candidates with full-precision scores before the final cut (FAISS "
        "IndexRefineFlat's k_factor); works with --storage_dtype "
        "int8/bfloat16 over float block files (per block), --pq_dir, and "
        "--ivf_dir (the refine store re-ranks the index's candidates "
        "against --ann_data_dir's rows; for PQ-coded lists this is the "
        "recall lever, since more probes cannot raise codec-capped "
        "recall). 0 = off. Errors with float32 flat search (exact already)",
    )
    parser.add_argument(
        "--matmul_precision", default="highest",
        choices=["highest", "high", "default"],
        help="flat search matmul precision: 'highest' is oracle-bit-exact "
        "(FAISS FlatIP parity; full f32, no TF32); 'high' / 'default' are "
        "a TF32 / a bf16 product on the card (f32 on the CPU), faster, "
        "close ranks can swap",
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
    parser.add_argument(
        "--ivf_dir", type=str, default="",
        help="search a prebuilt IVF index (build_ivf_index) instead of "
        "streaming --ann_data_dir's blocks: approximate top-N, --nprobe "
        "trades recall for speed. --ann_data_dir is still required",
    )
    parser.add_argument(
        "--nprobe", type=int, default=32,
        help="IVF only: sub-lists probed per query (nprobe >= nlist is "
        "exhaustive). For PQ-coded lists recall is capped by the codec: "
        "keep nprobe small and recover recall with --rescore_factor",
    )
    parser.add_argument(
        "--pq_dir", type=str, default="",
        help="search a prebuilt PQ index (build_ivf_index --index_type pq) "
        "instead of streaming --ann_data_dir's blocks: the corpus stays "
        "resident on the device as 48-96 B/row ADC codes. Approximate "
        "ranking; --rescore_factor re-ranks the recalled set exactly. "
        "--ann_data_dir is still required",
    )
    parser.add_argument("--no_mesh", action="store_true",
                        help="under torchrun, run each rank alone instead "
                        "of over an index-sharded mesh")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the "
                        "search phase into this dir (off when empty)")
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Exit, as the JAX driver does, on option combinations it refuses: two
    indexes, or a rescore that has nothing to refine."""
    if args.ivf_dir and args.pq_dir:
        raise SystemExit("--ivf_dir and --pq_dir are mutually exclusive")
    if (args.rescore_factor > 0 and not (args.ivf_dir or args.pq_dir)
            and args.storage_dtype == "float32"):
        raise SystemExit(
            "--rescore_factor refines approximate candidates; the float32 "
            "flat search is already exact. Combine it with --storage_dtype "
            "int8/bfloat16, --pq_dir, or --ivf_dir"
        )


def encode_queries(args, model_path, eval_file, dtype, device, *, mesh=None,
                   mesh_axis: str = "index"):
    """Load a model and embed all eval queries (reference evaluate(),
    :116-154). Returns (qids, [Q, E] f32 embeddings, raw sequences). With a
    ``mesh`` the encode is data parallel over ``mesh_axis`` (the axis the
    search shards the index over); every rank gets every row."""
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
    encode = make_query_encode_fn(model, mesh=mesh, data_axis=mesh_axis)
    qids, embs, raw = [], [], {}
    for batch in dataset.batches(args.per_gpu_eval_batch_size):
        ids = torch.from_numpy(batch["concat_ids"]).to(device)
        mask = torch.from_numpy(batch["concat_mask"]).to(device)
        embs.append(encode(ids, mask).cpu().numpy())
        qids.extend(batch["qid"])
        for qid, seq in zip(batch["qid"], batch["history_utterances"]):
            raw[qid] = seq
    return qids, np.concatenate(embs, axis=0), raw


def search_pq(args, query_embs, device, mesh=None):
    """``--pq_dir``: the ADC scan over the resident codes; with
    ``--rescore_factor`` its top ``factor * top_n`` ROW POSITIONS refined
    against ``--ann_data_dir``'s rows. Returns (scores, token-cache offsets)."""
    index = PQIndex.load(args.pq_dir, device=device)
    logger.info(
        "PQ search: ntotal=%d m=%d nbits=%d rescore_factor=%d",
        index.ntotal, index.codec.m, index.codec.nbits, args.rescore_factor,
    )
    with profile_trace(args.profile_dir), PhaseTimer("search", device=device):
        if args.rescore_factor > 0:
            _s, pos = index.adc_topk(query_embs, args.rescore_factor * args.top_n, mesh=mesh)
            return index.rescore(args.ann_data_dir, query_embs, pos, args.top_n)
        return index.search(query_embs, args.top_n, mesh=mesh)


def search_ivf(args, query_embs, device, mesh=None):
    """``--ivf_dir``: ``--nprobe`` sub-lists a query; with
    ``--rescore_factor`` the index's top ``factor * top_n`` rowids refined
    against ``--ann_data_dir``'s rows. The rowids are emb2offset payloads,
    so the result is token-cache offsets."""
    index = IVFIndex.load(args.ivf_dir, device=device)
    logger.info(
        "IVF search: nlist=%d cap=%d ntotal=%d nprobe=%d rescore_factor=%d",
        index.nlist, index.cap, index.ntotal, args.nprobe, args.rescore_factor,
    )
    with profile_trace(args.profile_dir), PhaseTimer("search", device=device):
        if args.rescore_factor <= 0:
            return index.search(query_embs, args.top_n, nprobe=args.nprobe, mesh=mesh)
        if index.storage_dtype in ("int8", "bfloat16"):
            # SQ8 list scores are integer-exact and bf16 lists reorder only
            # near-ties, so the refine buys (almost) no ranking quality
            logger.warning(
                "--rescore_factor on an IVF index with %s lists is a "
                "ranking no-op (the quantized list scores already match "
                "float ranking); it only costs a candidate-row refine. "
                "Drop it unless you need exact float scores in the run file.",
                index.storage_dtype,
            )
        _s, cand = index.search(
            query_embs, args.rescore_factor * args.top_n, nprobe=args.nprobe, mesh=mesh
        )
        return index.rescore(args.ann_data_dir, query_embs, cand, args.top_n)


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    check_ported(args)
    with driver_mesh(("index",), no_mesh=args.no_mesh, no_cuda=args.no_cuda) as (mesh, device):
        return infer(args, mesh, device)


def infer(args, mesh, device):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    offset2pid = load_offset2pid(args.processed_data_dir)
    qrels = load_qrels(args.qrels) if args.qrels else {}

    all_qids, all_embs, all_raw = [], [], {}
    if not args.cross_validate:
        qids, embs, raw = encode_queries(
            args, args.model_path, args.eval_file, dtype, device, mesh=mesh
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
                mesh=mesh,
            )
            all_qids.extend(qids)
            all_embs.append(embs)
            all_raw.update(raw)
    query_embs = np.concatenate(all_embs, axis=0)

    if args.pq_dir:
        scores, offsets = search_pq(args, query_embs, device, mesh)
    elif args.ivf_dir:
        scores, offsets = search_ivf(args, query_embs, device, mesh)
    else:
        searcher = BlockedSearcher(
            SearchConfig(
                storage_dtype=args.storage_dtype,
                matmul_precision=args.matmul_precision,
                max_device_block_bytes=args.max_device_block_bytes,
                rescore_factor=args.rescore_factor,
            ),
            device=device,
            mesh=mesh,
        )
        with profile_trace(args.profile_dir), PhaseTimer("search", device=device):
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
    writer = is_main_rank(mesh)
    run = write_run_outputs(
        all_qids, scores, offsets, offset2pid, args.top_n,
        output_trec_file=args.output_trec_file if writer else None,
        output_file=args.output_file if writer else None,
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
        if writer:
            print(json.dumps({"num_queries": len(per_q), **means}))
        barrier(mesh)
        return means
    barrier(mesh)
    return run


if __name__ == "__main__":
    main()
