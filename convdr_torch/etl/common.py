"""Shared ETL helpers: duplicate lists, qrels remapping, fold splits.

The counterpart of ``convdr_tpu/etl/common.py`` for the helpers that ranking
data needs. ``merge_car_marco_collection`` reads TREC-CAR's CBOR dump and
waits for the rest of the ETL (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

from convdr_torch.core.config import NUM_FOLD

CAR_BASE_ID = 10_000_000


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
