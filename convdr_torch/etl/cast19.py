"""CAsT-19 ETL: TREC-CAR + MS MARCO -> collection/topics/queries/qrels.

The counterpart of ``convdr_tpu/etl/cast19.py`` (byte-identical output
files), a behavioral port of the reference's data/preprocess_cast19.py
with the same output files and formats:

  * ``collection.tsv``     -- CAR passages re-id'd from CAR_BASE_ID
    (:71,81-83) followed by MARCO passages with duplicates removed (:87-95);
  * ``car_id_to_idx.pickle`` / ``car_idx_to_id.pickle`` id maps (:97-101);
  * ``eval_topics.jsonl`` (+ ``.0..4`` folds, topic-contiguous split
    :159-167) with cumulative ``input`` turns and manual ``target``
    (:129-157);
  * ``queries.raw.tsv`` / ``queries.manual.tsv``;
  * ``qrels.tsv`` with pids remapped (:169-181).

CAR cbor reading uses the built-in decoder
(:mod:`convdr_torch.etl.cbor_car`) instead of trec-car-tools.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List

from convdr_torch.etl.common import (
    contiguous_topic_folds,
    merge_car_marco_collection,
    remap_qrels,
    write_topics_with_folds,
)


def build_collection(
    car_cbor: str,
    msmarco_collection: str,
    duplicate_file: str,
    out_collection_file: str,
    car_id_to_idx_file: str,
    car_idx_to_id_file: str,
) -> Dict[str, int]:
    """Merge CAR + MARCO with dedup; returns car_id_to_idx."""
    car_id_to_idx, _ = merge_car_marco_collection(
        car_cbor,
        msmarco_collection,
        duplicate_file,
        out_collection_file,
        car_id_to_idx_file,
        car_idx_to_id_file,
        keep_in_memory=False,
    )
    return car_id_to_idx


def build_topics(
    cast_topics_raw_file: str,
    cast_topics_manual_file: str,
    out_topics_file: str,
    out_raw_queries_file: str,
    out_manual_queries_file: str,
) -> List[dict]:
    """Topics json + resolved tsv -> jsonl records with cumulative turns."""
    with open(cast_topics_raw_file) as f:
        raw_data = json.load(f)
    annotated: Dict[str, Dict[str, str]] = {}
    with open(cast_topics_manual_file) as fin, open(
        out_manual_queries_file, "w"
    ) as out_manual:
        for line in fin:
            out_manual.write(line)
            split = line.split("\t")
            topic_query, query = split[0], split[1].strip()
            topic_id, query_id = topic_query.split("_")
            annotated.setdefault(topic_id, {})[query_id] = query

    records: List[dict] = []
    topic_order: List[str] = []
    with open(out_raw_queries_file, "w") as out_raw:
        for group in raw_data:
            topic_number = str(group["number"])
            description = group.get("description", "")
            title = group.get("title", "")
            queries: List[str] = []
            for turn in group["turn"]:
                query_number = str(turn["number"])
                raw_utterance = turn["raw_utterance"]
                queries.append(raw_utterance)
                records.append(
                    {
                        "topic_number": topic_number,
                        "query_number": query_number,
                        "description": description,
                        "title": title,
                        "input": copy.deepcopy(queries),
                        "target": annotated[topic_number][query_number],
                    }
                )
                out_raw.write(f"{topic_number}_{query_number}\t{raw_utterance}\n")
                if topic_number not in topic_order:
                    topic_order.append(topic_number)

    folds = contiguous_topic_folds(topic_order)
    write_topics_with_folds(records, out_topics_file, folds)
    return records


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--car_cbor", type=str)
    parser.add_argument("--msmarco_collection", type=str)
    parser.add_argument("--duplicate_file", type=str)
    parser.add_argument("--cast_dir", type=str)
    parser.add_argument("--out_data_dir", type=str)
    parser.add_argument("--out_collection_dir", type=str)
    args = parser.parse_args(argv)

    os.makedirs(args.out_data_dir, exist_ok=True)
    os.makedirs(args.out_collection_dir, exist_ok=True)
    car_id_to_idx = build_collection(
        args.car_cbor,
        args.msmarco_collection,
        args.duplicate_file,
        os.path.join(args.out_collection_dir, "collection.tsv"),
        os.path.join(args.out_collection_dir, "car_id_to_idx.pickle"),
        os.path.join(args.out_collection_dir, "car_idx_to_id.pickle"),
    )
    build_topics(
        os.path.join(args.cast_dir, "evaluation_topics_v1.0.json"),
        os.path.join(
            args.cast_dir, "evaluation_topics_annotated_resolved_v1.0.tsv"
        ),
        os.path.join(args.out_data_dir, "eval_topics.jsonl"),
        os.path.join(args.out_data_dir, "queries.raw.tsv"),
        os.path.join(args.out_data_dir, "queries.manual.tsv"),
    )
    remap_qrels(
        os.path.join(args.cast_dir, "2019qrels.txt"),
        os.path.join(args.out_data_dir, "qrels.tsv"),
        car_id_to_idx,
    )


if __name__ == "__main__":
    main()
