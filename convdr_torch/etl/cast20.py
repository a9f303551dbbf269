"""CAsT-20 ETL: like CAsT-19 plus canonical-response text capture.

The counterpart of ``convdr_tpu/etl/cast20.py`` (byte-identical output
files), a behavioral port of the reference's data/preprocess_cast20.py: joins the
automatic and manual topic files turn-by-turn (:146-199), resolves each
turn's canonical result id to passage *text* (:124-135) kept from the merged
collection, and emits topics records carrying cumulative ``input``,
``manual_response``/``automatic_response`` text lists and their id lists.
Fold split is ``(topic - 81) // 5`` (:10-11).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Tuple

from convdr_torch.core.config import NUM_FOLD
from convdr_torch.etl.common import (
    merge_car_marco_collection,
    remap_qrels,
    write_topics_with_folds,
)


def cast20_fold(topic_number: int) -> int:
    return (int(topic_number) - 81) // NUM_FOLD


def build_collection_in_memory(
    car_cbor: str,
    msmarco_collection: str,
    duplicate_file: str,
    out_collection_file: str,
    car_id_to_idx_file: str,
    car_idx_to_id_file: str,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Merge CAR+MARCO keeping text in memory for response resolution.

    Returns (car_id_to_idx, collection{int pid: text}). If preprocessed
    outputs exist they are reloaded (preprocess_cast20.py:68-84).
    """
    return merge_car_marco_collection(
        car_cbor,
        msmarco_collection,
        duplicate_file,
        out_collection_file,
        car_id_to_idx_file,
        car_idx_to_id_file,
        keep_in_memory=True,
    )


def resolve_raw_id(
    raw_id: str, car_id_to_idx: Dict[str, int], collection: Dict[int, str]
) -> str:
    """MARCO_/CAR_ canonical result id -> passage text (:124-135)."""
    if raw_id.startswith("MARCO_"):
        new_id = int(raw_id[6:])
    elif raw_id.startswith("CAR_"):
        new_id = car_id_to_idx[raw_id]
    else:
        raise ValueError("Invalid document id")
    if new_id not in collection:
        raise ValueError("Unknown document")
    return collection[new_id]


def build_topics(
    auto_file: str,
    manual_file: str,
    out_topics_file: str,
    out_raw_queries_file: str,
    out_manual_queries_file: str,
    car_id_to_idx: Dict[str, int],
    collection: Dict[int, str],
) -> List[dict]:
    with open(auto_file) as f:
        auto_raw = json.load(f)
    with open(manual_file) as f:
        manual_raw = json.load(f)

    records: List[dict] = []
    fold_of_topic: Dict[str, int] = {}
    with open(out_raw_queries_file, "w") as out_raw, open(
        out_manual_queries_file, "w"
    ) as out_manual:
        for auto_topic, manual_topic in zip(auto_raw, manual_raw):
            topic_number = auto_topic["number"]
            assert topic_number == manual_topic["number"]
            fold_of_topic[str(topic_number)] = cast20_fold(topic_number)
            auto_turns, manual_turns = auto_topic["turn"], manual_topic["turn"]
            assert len(auto_turns) == len(manual_turns)
            inputs: List[str] = []
            manual_responses: List[str] = []
            auto_responses: List[str] = []
            manual_res_ids: List[str] = []
            auto_res_ids: List[str] = []
            for auto_turn, manual_turn in zip(auto_turns, manual_turns):
                query_number = auto_turn["number"]
                raw = auto_turn["raw_utterance"]
                inputs.append(raw)
                target = manual_turn["manual_rewritten_utterance"]

                manual_res_ids.append(manual_turn["manual_canonical_result_id"])
                manual_responses.append(
                    resolve_raw_id(
                        manual_turn["manual_canonical_result_id"],
                        car_id_to_idx,
                        collection,
                    )
                )
                auto_res_ids.append(auto_turn["automatic_canonical_result_id"])
                auto_responses.append(
                    resolve_raw_id(
                        auto_turn["automatic_canonical_result_id"],
                        car_id_to_idx,
                        collection,
                    )
                )
                records.append(
                    {
                        "topic_number": topic_number,
                        "query_number": query_number,
                        "input": copy.deepcopy(inputs),
                        "automatic_response_id": copy.deepcopy(auto_res_ids),
                        "automatic_response": copy.deepcopy(auto_responses),
                        "manual_response_id": copy.deepcopy(manual_res_ids),
                        "manual_response": copy.deepcopy(manual_responses),
                        "target": target,
                    }
                )
                out_raw.write(f"{topic_number}_{query_number}\t{raw}\n")
                out_manual.write(f"{topic_number}_{query_number}\t{target}\n")

    write_topics_with_folds(records, out_topics_file, fold_of_topic)
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
    car_id_to_idx, collection = build_collection_in_memory(
        args.car_cbor,
        args.msmarco_collection,
        args.duplicate_file,
        os.path.join(args.out_collection_dir, "collection.tsv"),
        os.path.join(args.out_collection_dir, "car_id_to_idx.pickle"),
        os.path.join(args.out_collection_dir, "car_idx_to_id.pickle"),
    )
    build_topics(
        os.path.join(args.cast_dir, "2020_automatic_evaluation_topics_v1.0.json"),
        os.path.join(args.cast_dir, "2020_manual_evaluation_topics_v1.0.json"),
        os.path.join(args.out_data_dir, "eval_topics.jsonl"),
        os.path.join(args.out_data_dir, "queries.raw.tsv"),
        os.path.join(args.out_data_dir, "queries.manual.tsv"),
        car_id_to_idx,
        collection,
    )
    remap_qrels(
        os.path.join(args.cast_dir, "2020qrels.txt"),
        os.path.join(args.out_data_dir, "qrels.tsv"),
        car_id_to_idx,
    )


if __name__ == "__main__":
    main()
