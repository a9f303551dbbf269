"""Corpus text loading and qrels parsing.

``load_collection`` mirrors reference utils/util.py:327-352 (tsv: pid,
text; jsonl: ``title[SEP]text``) but uses a dict keyed by pid instead of the
reference's preallocated 50M-slot Python list, so memory scales with the
corpus actually loaded. ``load_qrels`` mirrors
run_convdr_inference.py:372-385 including its quirk that a topic whose first
seen judgment is non-positive is skipped until a positive appears.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, Tuple

INVALID_DOC = "[INVALID DOC ID]"


class Collection:
    """pid -> passage text mapping with list-like indexing."""

    def __init__(self, passages: Dict[int, str]):
        self._passages = passages

    def __getitem__(self, pid: int) -> str:
        return self._passages.get(int(pid), INVALID_DOC)

    def __contains__(self, pid: int) -> bool:
        return int(pid) in self._passages

    def __len__(self) -> int:
        return len(self._passages)

    def items(self) -> Iterator[Tuple[int, str]]:
        return iter(self._passages.items())


def iter_collection(collection_file: str) -> Iterator[Tuple[int, str]]:
    ext = collection_file[collection_file.rfind(".") + 1 :]
    if ext not in ("jsonl", "tsv"):
        raise TypeError(f"Unrecognized collection file type: {ext}")
    with open(collection_file, "r", encoding="utf-8") as f:
        if ext == "jsonl":
            for line in f:
                obj = json.loads(line.strip())
                yield int(obj["id"]), obj["title"] + "[SEP]" + obj["text"]
        else:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                try:
                    pid = int(parts[0])
                except ValueError:
                    continue
                yield pid, parts[1].rstrip()


def load_collection(collection_file: str) -> Collection:
    return Collection(dict(iter_collection(collection_file)))


def find_collection(raw_data_dir: str) -> str:
    """collection.jsonl preferred over collection.tsv (inference.py:79-85)."""
    for name in ("collection.jsonl", "collection.tsv"):
        path = os.path.join(raw_data_dir, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"Neither collection.tsv nor collection.jsonl found in {raw_data_dir}"
    )


def load_qrels(qrels_file: str) -> Dict[str, Dict[int, int]]:
    """qrels tsv -> {topicid: {docid: rel}} (run_convdr_inference.py:372-385)."""
    positive: Dict[str, Dict[int, int]] = {}
    with open(qrels_file, "r", encoding="utf8") as f:
        for row in csv.reader(f, delimiter="\t"):
            topicid, _, docid, rel = row[0], row[1], int(row[2]), int(row[3])
            topicid = str(topicid)
            if topicid not in positive:
                if rel > 0:
                    positive[topicid] = {docid: rel}
            else:
                positive[topicid][docid] = rel
    return positive


def load_queries_tsv(path: str) -> Dict[str, str]:
    queries: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            qid, query = line.strip().split("\t")
            queries[qid] = query
    return queries
