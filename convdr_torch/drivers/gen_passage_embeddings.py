"""CLI: embed the tokenized corpus into retrieval blocks.

The counterpart of ``convdr_tpu/drivers/gen_passage_embeddings.py`` with the
same flags plus the reference's ``--no_cuda``: the encoder runs on the card
unless ``--no_cuda`` asks for the CPU, and without a card it raises. One
process drives one GPU. Under ``torchrun`` (``WORLD_SIZE`` in the
environment) the ranks form a ``("data",)`` mesh, unless ``--no_mesh``,
the batch is ``--per_gpu_eval_batch_size`` times the mesh size, each rank
encodes its slice of every batch and rank 0 writes the blocks, the same
rows in the same order as one process writes. Blocks are written in the reference's f32 pickle
format, with ``--storage_dtype bfloat16`` as bf16 rows (half the disk and
device memory), or with ``--storage_dtype int8`` as SQ8 int8 rows plus the
``int8_scales.npy`` sidecar (a quarter; see ``ops/quant.py``).
``--block_format native`` writes each block as one ``.cnb`` file of the
C++ block store (``native_io.py``) instead of a pickle pair.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from convdr_torch.core.loading import (
    gelu_arch_overrides,
    load_model_and_params,
    make_apply_fn,
)
from convdr_torch.core.registry import MODEL_REGISTRY
from convdr_torch.data.token_cache import TokenCache
from convdr_torch.parallel.mesh import axis_size, driver_mesh
from convdr_torch.retrieval.embed_corpus import (
    default_length_buckets,
    generate_embeddings,
)

logger = logging.getLogger(__name__)


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True, type=str,
                        help="Dir holding the tokenized 'passages' cache")
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument("--model_type", required=True, type=str,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--output_dir", required=True, type=str)
    parser.add_argument("--cache_dir", default=None, type=str)
    parser.add_argument("--max_seq_length", default=512, type=int)
    parser.add_argument("--max_query_length", default=64, type=int)
    parser.add_argument("--max_doc_character", default=10000, type=int)
    parser.add_argument("--per_gpu_eval_batch_size", default=64, type=int)
    parser.add_argument("--num_blocks", default=1, type=int)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="compute dtype for the encoder")
    parser.add_argument("--gelu", default="auto",
                        choices=["auto", "erf", "tanh"],
                        help="GELU flavor; auto = tanh under bf16 (inside "
                        "bf16 noise), erf under f32")
    parser.add_argument("--arch_size", default="base", choices=["base", "tiny"],
                        help="tiny = miniature architecture for smoke tests")
    parser.add_argument("--no_mesh", action="store_true",
                        help="under torchrun, encode on each rank alone "
                        "instead of over a data-parallel mesh")
    parser.add_argument("--no_cuda", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
    parser.add_argument(
        "--storage_dtype", default="float32",
        choices=["float32", "bfloat16", "int8"],
        help="on-disk block dtype: float32 (reference-format blocks), "
        "bfloat16 (half disk+device memory) or int8 (SQ8 scalar "
        "quantization, quarter disk+device memory; writes an "
        "int8_scales.npy sidecar)",
    )
    parser.add_argument("--block_format", default="pickle",
                        choices=["pickle", "native"],
                        help="'pickle' (reference-compatible .pb pairs) or "
                        "'native' (one .cnb file a block, C++ block store)")
    parser.add_argument("--length_buckets", default="auto",
                        help="'auto' (64/128/.../record-length rungs), "
                        "'none', or a comma list, e.g. 128,512; short "
                        "passages encode at their rung instead of full "
                        "padded length (same embeddings, less compute)")
    return parser.parse_args(argv)


def resolve_length_buckets(spec: str, record_len: int, multi_chunk: bool,
                           chunk_len: int = 512):
    """Parse the --length_buckets flag against the cache record length.

    Multi-chunk models accept only chunk-multiple rungs (an explicit spec
    like ``512,1024,2048``); 'auto' stays off for multi-chunk (index row
    parity with the reference).
    """
    if spec == "none" or (spec == "auto" and multi_chunk):
        return None
    if spec == "auto":
        return default_length_buckets(record_len)
    try:
        buckets = tuple(sorted({int(x) for x in spec.split(",")}))
    except ValueError as e:
        raise ValueError(f"bad --length_buckets {spec!r}: {e}") from e
    if not buckets or buckets[0] < 1:
        raise ValueError(
            f"--length_buckets {spec!r}: rungs must be positive integers"
        )
    if multi_chunk and any(b % chunk_len for b in buckets):
        raise ValueError(
            f"--length_buckets {spec!r}: multi-chunk rungs must be "
            f"multiples of chunk_len={chunk_len}"
        )
    return buckets


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    args = get_arguments(argv)
    with driver_mesh(("data",), no_mesh=args.no_mesh, no_cuda=args.no_cuda) as (mesh, device):
        return embed(args, mesh, device)


def embed(args, mesh, device):
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    preset = "tiny" if args.arch_size == "tiny" else None
    config, _, model = load_model_and_params(
        args.model_type, args.checkpoint, device=device, dtype=dtype,
        arch_preset=preset,
        arch_overrides=gelu_arch_overrides(args.gelu, args.dtype),
    )
    cache = TokenCache(os.path.join(args.data_dir, "passages"))
    capacity = config.arch.max_position_embeddings - config.arch.position_offset
    if not config.multi_chunk and cache.max_seq_length > capacity:
        # A valid token past the position table would index out of range:
        # a device-side assert on CUDA. Multi-chunk models are exempt:
        # body_emb reshapes records into chunk_len-wide chunks first.
        raise ValueError(
            f"token cache records are {cache.max_seq_length} tokens but the "
            f"model's position-embedding capacity is {capacity}; re-tokenize "
            "with a smaller --max_seq_length or use a multi-chunk model"
        )
    buckets = resolve_length_buckets(
        args.length_buckets, cache.max_seq_length, config.multi_chunk,
        config.chunk_len,
    )
    batch = args.per_gpu_eval_batch_size
    if mesh is not None:
        batch *= axis_size(mesh, "data")
    rows = generate_embeddings(
        make_apply_fn(model),
        cache,
        args.output_dir,
        device=device,
        batch_size=batch,
        num_blocks=args.num_blocks,
        mesh=mesh,
        length_buckets=buckets,
        block_format=args.block_format,
        storage_dtype=args.storage_dtype,
    )
    logger.info("wrote %d embedding rows to %s", rows, args.output_dir)
    return rows


if __name__ == "__main__":
    main()
