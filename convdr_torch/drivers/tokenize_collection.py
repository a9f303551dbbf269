"""CLI: tokenize a collection into the binary token cache.

The counterpart of ``convdr_tpu/drivers/tokenize_collection.py`` with the
same flags (the reference's data/tokenizing.py:223-272 --collection,
--out_data_dir, --model_name_or_path, --model_type, --max_seq_length,
--max_doc_character, plus --num_workers, --queries and
--max_query_length). Host work only: it needs no card and imports no
``torch``, so its spawned workers start quickly.

    python -m convdr_torch.drivers.tokenize_collection \\
        --collection collection.tsv --out_data_dir processed \\
        --model_type rdot_nll --num_workers 8 --queries queries.raw.tsv
"""

from __future__ import annotations

import argparse
import logging
import os

from convdr_torch.core.config import DataConfig
from convdr_torch.core.registry import MODEL_REGISTRY, get_model_config
from convdr_torch.data.tokenize_pipeline import tokenize_collection, tokenize_queries_file
from convdr_torch.data.tokenizers import load_tokenizer


def get_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--collection", required=True, type=str,
                        help="Input collection .tsv or .jsonl")
    parser.add_argument("--out_data_dir", required=True, type=str)
    parser.add_argument(
        "--model_name_or_path", default="tiny", type=str,
        help="Tokenizer vocab dir (or 'tiny' for the test vocab)",
    )
    parser.add_argument("--model_type", required=True, type=str,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--max_seq_length", default=512, type=int)
    parser.add_argument("--max_doc_character", default=10000, type=int,
                        help="char pre-truncation before tokenizing")
    parser.add_argument("--num_workers", default=32, type=int)
    parser.add_argument(
        "--queries", nargs="*", default=[], type=str,
        help="Optional qid\\tquery .tsv files; each is tokenized into "
             "<out_data_dir>/<stem> query cache + qid<->offset maps "
             "(reference query-cache path, data/tokenizing.py:119-130)",
    )
    parser.add_argument("--max_query_length", default=64, type=int)
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_arguments(argv)
    model_config = get_model_config(args.model_type)
    count = tokenize_collection(
        args.collection,
        args.out_data_dir,
        tokenizer_kind=model_config.tokenizer_kind,
        tokenizer_path=args.model_name_or_path,
        config=DataConfig(
            max_seq_length=args.max_seq_length,
            max_doc_character=args.max_doc_character,
        ),
        num_workers=args.num_workers,
    )
    print(f"Total lines written: {count}")
    if args.queries:
        tokenizer = load_tokenizer(
            model_config.tokenizer_kind, args.model_name_or_path
        )
        for qpath in args.queries:
            stem = os.path.splitext(os.path.basename(qpath))[0]
            n = tokenize_queries_file(
                qpath, os.path.join(args.out_data_dir, stem),
                tokenizer=tokenizer,
                max_query_length=args.max_query_length,
            )
            print(f"Query cache {stem}: {n} queries")
    return count


if __name__ == "__main__":
    main()
