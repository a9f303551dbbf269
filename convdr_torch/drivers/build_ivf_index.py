"""CLI: build an ANN index (IVF or PQ) from embedding blocks.

The counterpart of ``convdr_tpu/drivers/build_ivf_index.py``, flag for flag,
with the same summary JSON line. Offline indexes invert FAISS's in-process
economics: cluster/quantize + pack once (this driver), then serve many
inference runs, IVF at a fraction of the exact scan's cost
(``run_convdr_inference --ivf_dir ... --nprobe ...``) and PQ with the whole
corpus resident on the card at 48-96 bytes a row
(``run_convdr_inference --pq_dir ...``).

Input: a ``gen_passage_embeddings`` output directory (float32 / bfloat16 /
int8 block files + sidecars). Output: an index directory that
:class:`convdr_torch.retrieval.ivf.IVFIndex` or
:class:`convdr_torch.retrieval.pq_index.PQIndex` (and the JAX package's
classes) load. k-means and encoding run on the card unless ``--no_cuda``
asks for the CPU; without a card it raises.

    python -m convdr_torch.drivers.build_ivf_index --ann_data_dir emb \
        --index_dir ivf --nlist 1024 [--storage_dtype int8] [--no_cuda]
"""

from __future__ import annotations

import argparse
import json
import logging

from convdr_torch.core.device import resolve_device
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex

logger = logging.getLogger(__name__)


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--ann_data_dir", type=str, required=True,
        help="embedding block directory (gen_passage_embeddings output)",
    )
    parser.add_argument(
        "--index_dir", type=str, required=True,
        help="output directory for the built index",
    )
    parser.add_argument(
        "--index_type", default="ivf", choices=["ivf", "pq"],
        help="ivf = inverted lists over the stored rows (low-latency "
        "probing); pq = product-quantized flat codes (48-96 B/row, whole "
        "corpus resident on the device)",
    )
    parser.add_argument(
        "--nlist", type=int, default=0,
        help="IVF: number of inverted lists (k-means centroids); FAISS "
        "rule of thumb ~sqrt(N)..16*sqrt(N)",
    )
    parser.add_argument(
        "--pq_m", type=int, default=96,
        help="PQ: subquantizer count (code bytes per row); dim must "
        "divide by it",
    )
    parser.add_argument(
        "--pq_nbits", type=int, default=8, choices=[4, 8],
        help="PQ: bits per subquantizer. 4 => 16 centroids, ADC sweep "
        "~2x an exact-scan matmul; 8 => 256 centroids, better recall, "
        "ADC ~32x (use with IVF probing or small corpora)",
    )
    parser.add_argument(
        "--storage_dtype", default="float32",
        choices=["float32", "bfloat16", "int8", "pq4", "pq8"],
        help="IVF list-tensor dtype. int8 = SQ8 (quarter the device "
        "memory, integer-exact candidate scoring); pq4/pq8 = PQ codes "
        "(--pq_m bytes/row, the FAISS IVFPQ composition); int8 BLOCK files "
        "force int8 or pq",
    )
    parser.add_argument(
        "--slack", type=float, default=1.0,
        help="sub-list capacity = slack * N / nlist (a cluster of l rows "
        "occupies ceil(l/cap) fixed-capacity sub-lists; smaller = finer "
        "probe granularity, more zero-pad rows)",
    )
    parser.add_argument(
        "--opq_iters", type=int, default=0,
        help="PQ/pq4/pq8: alternating-optimization iterations for the OPQ "
        "rotation (0 = plain PQ); ~6 for real encoder embeddings, whose "
        "correlated learned dims are what the rotation fixes (on synthetic "
        "isotropic mixtures it does nothing). One-time training cost; "
        "search speed is unchanged (the rotation folds into encode/query "
        "LUTs)",
    )
    parser.add_argument(
        "--pack_codes", action="store_true",
        help="PQ nbits=4 only: store codes 2-per-byte (half the device "
        "memory and disk: 38M rows at m=96 drop 3.4 -> 1.7 GB; FAISS's "
        "packed-pq4 layout)",
    )
    parser.add_argument(
        "--from_pq_dir", type=str, default="",
        help="IVF: promote an existing flat PQ index (a --index_type pq "
        "output over the SAME blocks) to IVFPQ by reusing its codec and "
        "codes verbatim: one assignment pass instead of a re-encode "
        "(FAISS's precomputed-codes add_core path). Overrides "
        "--storage_dtype/--pq_*/--pack_codes with the source index's",
    )
    parser.add_argument("--kmeans_iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--train_sample", type=int, default=0,
        help="k-means training subsample cap (0 = train on all of block "
        "0; FAISS uses ~256 rows per centroid)",
    )
    parser.add_argument("--max_blocks", type=int, default=0,
                        help="index only the first N blocks (0 = all)")
    parser.add_argument("--no_cuda", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    device = resolve_device(args.no_cuda)
    if args.pack_codes and not (
        (args.index_type == "pq" and args.pq_nbits == 4)
        or (args.index_type == "ivf" and args.storage_dtype == "pq4")
    ):
        raise SystemExit(
            "--pack_codes applies to nbits=4 codes only (--index_type pq "
            "--pq_nbits 4, or --index_type ivf --storage_dtype pq4)"
        )
    if args.index_type == "pq":
        index = PQIndex.build_from_blocks(
            args.ann_data_dir,
            args.pq_m,
            args.pq_nbits,
            iters=args.kmeans_iters,
            seed=args.seed,
            train_sample=args.train_sample or None,
            max_blocks=args.max_blocks or None,
            opq_iters=args.opq_iters,
            pack=args.pack_codes,
            device=device,
        )
        index.save(args.index_dir)
        summary = {
            "index_dir": args.index_dir,
            "index_type": "pq",
            "m": index.codec.m,
            "nbits": index.codec.nbits,
            "opq": index.codec.rotation is not None,
            "packed": index.packed,
            "dim": index.dim,
            "ntotal": index.ntotal,
            "code_tensor_bytes": int(index.codes.nbytes),
        }
        logger.info("built PQ index: %s", summary)
        print(json.dumps(summary))
        return summary
    if args.nlist <= 0:
        raise SystemExit("--nlist is required for --index_type ivf")
    if args.from_pq_dir:
        source = PQIndex.load(args.from_pq_dir, device=device)
        index = IVFIndex.from_pq_index(
            source,
            args.ann_data_dir,
            args.nlist,
            slack=args.slack,
            iters=args.kmeans_iters,
            seed=args.seed,
            train_sample=args.train_sample or None,
            max_blocks=args.max_blocks or None,
            device=device,
        )
    else:
        index = IVFIndex.build_from_blocks(
            args.ann_data_dir,
            args.nlist,
            storage_dtype=args.storage_dtype,
            slack=args.slack,
            iters=args.kmeans_iters,
            seed=args.seed,
            train_sample=args.train_sample or None,
            max_blocks=args.max_blocks or None,
            pq_m=args.pq_m,
            opq_iters=args.opq_iters,
            pack=args.pack_codes,
            device=device,
        )
    index.save(args.index_dir)
    summary = {
        "index_dir": args.index_dir,
        "index_type": "ivf",
        "nlist": index.nlist,
        "cap": index.cap,
        "dim": index.dim,
        "ntotal": index.ntotal,
        "storage_dtype": index.storage_dtype,
        "packed": index.packed,
        "list_tensor_bytes": int(index.lists.nbytes),
        **{f"assign_{k}": v for k, v in index.stats.items()},
    }
    logger.info("built IVF index: %s", summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
