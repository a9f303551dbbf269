"""Shared ETL helpers: the CAR + MARCO merge, duplicate lists, qrels
remapping, fold splits.

The counterpart of ``convdr_tpu/etl/common.py``, function for function;
``merge_car_marco_collection`` reads TREC-CAR's CBOR dump through the
port's own decoder (:mod:`convdr_torch.etl.cbor_car`).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterable, List

from convdr_torch.core.config import NUM_FOLD
from convdr_torch.etl.cbor_car import iter_paragraphs

CAR_BASE_ID = 10_000_000


def merge_car_marco_collection(
    car_cbor: str,
    msmarco_collection: str,
    duplicate_file: str,
    out_collection_file: str,
    car_id_to_idx_file: str,
    car_idx_to_id_file: str,
    *,
    keep_in_memory: bool = False,
):
    """Merge TREC-CAR + MS MARCO with dedup and CAR re-ids (the shared core
    of preprocess_cast19.py:61-101 and preprocess_cast20.py:64-119).

    Returns ``(car_id_to_idx, collection_or_None)``; ``keep_in_memory``
    additionally keeps {int pid: text} for canonical-response resolution
    (CAsT-20). Existing outputs are reloaded instead of rebuilt.
    """
    collection: Dict[int, str] = {} if keep_in_memory else None
    if all(
        os.path.exists(p)
        for p in (out_collection_file, car_id_to_idx_file, car_idx_to_id_file)
    ):
        with open(car_id_to_idx_file, "rb") as f:
            car_id_to_idx = pickle.load(f)
        if keep_in_memory:
            with open(out_collection_file) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    try:
                        collection[int(parts[0])] = parts[1]
                    except ValueError:
                        continue
        return car_id_to_idx, collection

    sim_dict = parse_sim_file(duplicate_file)
    car_id_to_idx: Dict[str, int] = {}
    car_idx_to_id: List[str] = []
    i = 0
    with open(out_collection_file, "w") as out:
        with open(car_cbor, "rb") as f:
            for para in iter_paragraphs(f):
                car_id = "CAR_" + para.para_id
                text = (
                    para.get_text()
                    .replace("\t", " ")
                    .replace("\n", " ")
                    .replace("\r", " ")
                )
                idx = CAR_BASE_ID + i
                car_id_to_idx[car_id] = idx
                car_idx_to_id.append(car_id)
                if keep_in_memory:
                    collection[idx] = text
                out.write(f"{idx}\t{text}\n")
                i += 1
        with open(msmarco_collection) as m:
            for line in m:
                marco_id, text = line.strip().split("\t")
                if ("MARCO_" + marco_id) in sim_dict:
                    continue
                if keep_in_memory:
                    collection[int(marco_id)] = text
                out.write(f"{marco_id}\t{text}\n")
    with open(car_id_to_idx_file, "wb") as f:
        pickle.dump(car_id_to_idx, f)
    with open(car_idx_to_id_file, "wb") as f:
        pickle.dump(car_idx_to_id, f)
    return car_id_to_idx, collection


def parse_sim_file(filename: str) -> Dict[str, int]:
    """Duplicate-passage file: ``kept:dup1,dup2`` per line -> {dup_id: 1}
    (preprocess_cast19.py:11-26)."""
    sim_dict: Dict[str, int] = {}
    with open(filename) as f:
        for line in f:
            data = line.strip().split(":")
            if len(data) > 1 and len(data[1]) > 0:
                for doc in data[-1].split(","):
                    sim_dict[doc] = 1
    return sim_dict


def remap_qrels(
    in_path: str, out_path: str, car_id_to_idx: Dict[str, int]
) -> None:
    """CAR_/MARCO_ prefixed qrels -> integer-pid tsv
    (preprocess_cast19.py:169-181)."""
    with open(in_path) as oq, open(out_path, "w") as nq:
        for line in oq:
            qid, _, pid, rel = line.strip().split()
            if pid.startswith("CAR_"):
                pid = str(car_id_to_idx[pid])
            elif pid.startswith("MARCO_"):
                pid = str(int(pid[6:]))
            else:
                continue
            nq.write(f"{qid}\t0\t{pid}\t{rel}\n")


def write_topics_with_folds(
    records: List[dict],
    out_topics_file: str,
    fold_of_topic: Dict[str, int],
) -> None:
    """eval_topics.jsonl + per-fold .0..4 files."""
    with open(out_topics_file, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    for fold in range(NUM_FOLD):
        with open(f"{out_topics_file}.{fold}", "w") as f:
            for rec in records:
                if fold_of_topic[str(rec["topic_number"])] == fold:
                    f.write(json.dumps(rec) + "\n")


def contiguous_topic_folds(topic_order: Iterable[str]) -> Dict[str, int]:
    """CAsT-19 fold rule: topics in first-seen order, ``idx // (T // 5)``
    (preprocess_cast19.py:159-167). With a topic count that 5 does not
    divide, the tail topics land on fold indices >= NUM_FOLD and are absent
    from every fold file, as in the reference."""
    topics = list(dict.fromkeys(topic_order))
    per_fold = max(len(topics) // NUM_FOLD, 1)
    return {t: i // per_fold for i, t in enumerate(topics)}


def load_fold_assignment(topics_file: str) -> Dict[str, int]:
    """qid -> fold, read from existing ``eval_topics.jsonl.{i}`` files (the
    reference hardcodes the same assignment, gen_ranking_data.py:11-491)."""
    assignment: Dict[str, int] = {}
    for fold in range(NUM_FOLD):
        path = f"{topics_file}.{fold}"
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "topic_number" in rec:
                    qid = f"{rec['topic_number']}_{rec['query_number']}"
                else:
                    qid = str(rec["qid"])
                assignment[qid] = fold
    return assignment
