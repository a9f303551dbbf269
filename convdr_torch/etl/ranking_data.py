"""Hard-negative mining: manual-run TREC file -> ranking training jsonl.

The counterpart of ``convdr_tpu/etl/ranking_data.py``, the reference's
data/gen_ranking_data.py:493-610; with the same ``--seed`` both write the
same bytes:

  * qrels split into positives (rel>0) and judged negatives (:509-528);
  * negatives per query: judged-negative run docs first (:539-552), topped
    up with unjudged run docs to 20 (:554-567);
  * per query: highest-rel positive (:584-590), ``num_negs`` sampled
    negatives (:591-592), the topic record augmented with
    ``doc_pos``/``doc_negs`` text + ids (:593-604);
  * ``--cast`` additionally routes each record to its fold file. The
    reference hardcodes a 480-line qid->fold dict (:11-491); here the same
    assignment is read from the ``eval_topics.jsonl.{fold}`` files the
    preprocessors emit (--fold_topics).
"""

from __future__ import annotations

import argparse
import copy
import csv
import json
import random
from typing import Dict, List

from convdr_torch.core.config import NUM_FOLD
from convdr_torch.data.collection import load_collection
from convdr_torch.etl.common import load_fold_assignment

NEGATIVE_POOL_CAP = 20


def parse_qrels_pos_neg(qrels_path: str):
    query_positive: Dict[str, Dict[int, int]] = {}
    query_negative: Dict[str, List[int]] = {}
    with open(qrels_path, "r", encoding="utf8") as f:
        for topicid, _, docid, rel in csv.reader(f, delimiter="\t"):
            docid, rel = int(docid), int(rel)
            if rel > 0:
                query_positive.setdefault(topicid, {})[docid] = rel
            else:
                query_negative.setdefault(topicid, []).append(docid)
    return query_positive, query_negative


def collect_negatives(
    run_path: str,
    query_positive: Dict[str, Dict[int, int]],
    query_negative: Dict[str, List[int]],
) -> Dict[str, List[int]]:
    negatives: Dict[str, List[int]] = {}
    # pass 1: judged negatives from the run
    with open(run_path) as f:
        for line in f:
            qid, _, pid, *_ = line.strip().split()
            pid = int(pid)
            positive_ids = query_positive.get(qid, {})
            if positive_ids and pid not in positive_ids:
                if qid in query_negative and pid in query_negative[qid]:
                    negatives.setdefault(qid, []).append(pid)
    # pass 2: top up with unjudged run docs (may be false negatives)
    with open(run_path) as f:
        for line in f:
            qid, _, pid, *_ = line.strip().split()
            pid = int(pid)
            if qid in negatives and len(negatives[qid]) >= NEGATIVE_POOL_CAP:
                continue
            positive_ids = query_positive.get(qid, {})
            if positive_ids and pid not in positive_ids:
                negatives.setdefault(qid, []).append(pid)
    return negatives


def generate_ranking_data(
    train_path: str,
    run_path: str,
    qrels_path: str,
    collection_path: str,
    output_path: str,
    *,
    num_negs: int = 9,
    cast: bool = False,
    fold_topics: str = None,
    seed: int = None,
) -> int:
    query_positive, query_negative = parse_qrels_pos_neg(qrels_path)

    cqr: Dict[str, dict] = {}
    with open(train_path) as f:
        for line in f:
            obj = json.loads(line)
            qid = (
                f"{obj['topic_number']}_{obj['query_number']}"
                if "topic_number" in obj
                else str(obj["qid"])
            )
            cqr[qid] = obj

    negatives = collect_negatives(run_path, query_positive, query_negative)
    all_passages = load_collection(collection_path)

    rng = random.Random(seed)
    items = list(negatives.items())
    rng.shuffle(items)

    qid_to_fold = {}
    fold_files = []
    if cast:
        source = fold_topics or train_path
        qid_to_fold = load_fold_assignment(source)
        fold_files = [open(f"{output_path}.{x}", "w") for x in range(NUM_FOLD)]

    written = 0
    skipped_no_fold = 0
    try:
        written, skipped_no_fold = _write_records(
            output_path, items, query_positive, qid_to_fold, cast,
            fold_files, rng, num_negs, cqr, all_passages,
        )
    finally:
        for f in fold_files:
            f.close()
    if skipped_no_fold:
        print(f"skipped {skipped_no_fold} queries with no fold assignment")
    return written


def _write_records(output_path, items, query_positive, qid_to_fold, cast,
                   fold_files, rng, num_negs, cqr, all_passages):
    written = 0
    skipped_no_fold = 0
    with open(output_path, "w") as out:
        for qid, negs in items:
            if qid not in query_positive:
                continue
            if cast and qid not in qid_to_fold:
                # topics parked past NUM_FOLD by the contiguous split appear
                # in no fold file (see contiguous_topic_folds); they cannot
                # be routed, so skip rather than crash mid-write
                skipped_no_fold += 1
                continue
            positives = query_positive[qid]
            max_positive = max(positives, key=lambda p: positives[p])
            sampled = (
                rng.sample(negs, num_negs) if len(negs) > num_negs else negs
            )
            record = copy.deepcopy(cqr[qid])
            record.update(
                {
                    "doc_pos": all_passages[max_positive],
                    "doc_pos_id": max_positive,
                    "doc_negs": [all_passages[x] for x in sampled],
                    "doc_negs_id": list(sampled),
                }
            )
            line = json.dumps(record) + "\n"
            if cast:
                fold_files[qid_to_fold[qid]].write(line)
            out.write(line)
            written += 1
    return written, skipped_no_fold


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", type=str)
    parser.add_argument("--run", type=str)
    parser.add_argument("--qrels", type=str)
    parser.add_argument("--output", type=str)
    parser.add_argument("--collection", type=str)
    parser.add_argument("--cast", action="store_true")
    parser.add_argument("--num_negs", type=int, default=9)
    parser.add_argument(
        "--fold_topics",
        type=str,
        default=None,
        help="eval_topics.jsonl base whose .{fold} files define qid->fold "
        "(defaults to --train)",
    )
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    n = generate_ranking_data(
        args.train,
        args.run,
        args.qrels,
        args.collection,
        args.output,
        num_negs=args.num_negs,
        cast=args.cast,
        fold_topics=args.fold_topics,
        seed=args.seed,
    )
    print(f"wrote {n} ranking records")


if __name__ == "__main__":
    main()
