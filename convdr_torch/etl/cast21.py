"""CAsT-21 ETL: KILT/MARCO-docs/WaPo SGML-ish corpora -> framework inputs.

The counterpart of ``convdr_tpu/etl/cast21.py`` (byte-identical output
files and id maps), a behavioral port of the reference's
data/preprocess_cast21.py:

  * a scanner for ``<DOCNO>``/``<TITLE>``/``<passage id=N>`` documents
    (one union pattern over the reference's tag grammar, :175-221) producing dense-pid ``collection.tsv`` rows of
    ``title + " " + passage`` and composite ``docid-pid`` external ids;
  * ``doc_id_to_idx.pickle`` / ``doc_idx_to_id.pickle`` maps (:99-103);
  * manual topics json -> ``eval_topics.jsonl`` (+ folds
    ``(topic-106)//5``, :10-11), queries tsvs, and pseudo-qrels from the
    canonical result of each turn (:164);
"""

from __future__ import annotations

import argparse
import copy
import logging
import re
import json
import os
import pickle
from typing import Dict, List, TextIO, Tuple

from convdr_torch.core.config import NUM_FOLD
from convdr_torch.etl.common import write_topics_with_folds


def cast21_fold(topic_number: int) -> int:
    return (int(topic_number) - 106) // NUM_FOLD


# The reference's tag grammar (preprocess_cast21.py:175-221) as one union
# pattern: a DOCNO or TITLE sets parser state; each passage emits a record
# against the most recent docno/title. Non-greedy bodies with re.S reproduce
# the reference's scan-to-next-closer semantics (content may span lines);
# the pid part runs to the first ``>`` exactly as its ``find(">")`` did.
_TAG_RE = re.compile(
    r"<DOCNO>(?P<docno>.*?)</DOCNO>"
    r"|<TITLE>(?P<title>.*?)</TITLE>"
    r"|<passage id=(?P<pid>[^>]*)>(?P<body>.*?)</passage>",
    re.S,
)


def parse_documents(
    all_content: str,
    doc_id_to_idx: Dict[str, int],
    doc_idx_to_id: List[str],
    collection: Dict[int, str],
    out: TextIO,
    pidx: int = 0,
) -> int:
    """Scan ``<DOCNO>``/``<TITLE>``/``<passage id=N>`` corpora
    (KILT / MARCO-docs / WaPo; reference preprocess_cast21.py:175-221).

    Output-equivalent to the reference's character scanner on well-formed
    input: same dense pids, same ``docid-pid`` composite external ids,
    same ``title + " " + passage`` text with whitespace normalization and
    numeric pid canonicalization (``id=007`` -> ``7``). Sole deviation: an
    unclosed tag is skipped rather than raising ``AssertionError``
    mid-corpus (leftmost-match scanning simply finds no record there).
    """
    docid = None
    title = None
    last_end = 0
    for m in _TAG_RE.finditer(all_content):
        last_end = m.end()
        if m.group("docno") is not None:
            docid = m.group("docno")
        elif m.group("title") is not None:
            title = m.group("title")
        else:
            pid = str(int(m.group("pid")))
            passage = (
                m.group("body")
                .strip()
                .replace("\n", " ")
                .replace("\t", " ")
                .strip()
            )
            text = title + " " + passage
            composite = docid + "-" + pid
            doc_id_to_idx[composite] = pidx
            doc_idx_to_id.append(composite)
            collection[pidx] = text
            out.write(f"{pidx}\t{text}\n")
            pidx += 1
    # A passage opener past the last match means an unclosed tag was
    # skipped (the reference's scanner would have raised mid-corpus);
    # surface it loudly -- a silently shorter collection shifts every
    # later dense pid and misaligns qrels downstream.
    if "<passage id=" in all_content[last_end:]:
        logging.getLogger(__name__).warning(
            "unclosed <passage> tag after offset %d: corpus likely "
            "truncated or corrupt; %d passages parsed", last_end, pidx,
        )
    return pidx


def build_collection(
    corpus_files: List[str],
    out_collection_file: str,
    doc_id_to_idx_file: str,
    doc_idx_to_id_file: str,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    doc_id_to_idx: Dict[str, int] = {}
    doc_idx_to_id: List[str] = []
    collection: Dict[int, str] = {}
    if all(
        os.path.exists(p)
        for p in (out_collection_file, doc_id_to_idx_file, doc_idx_to_id_file)
    ):
        with open(doc_id_to_idx_file, "rb") as f:
            doc_id_to_idx = pickle.load(f)
        with open(out_collection_file) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                try:
                    collection[int(parts[0])] = parts[1]
                except ValueError:
                    continue
        return doc_id_to_idx, collection

    pidx = 0
    with open(out_collection_file, "w") as out:
        for path in corpus_files:
            if not path:
                continue
            with open(path) as f:
                all_content = f.read()
            pidx = parse_documents(
                all_content, doc_id_to_idx, doc_idx_to_id, collection, out, pidx
            )
    with open(doc_id_to_idx_file, "wb") as f:
        pickle.dump(doc_id_to_idx, f)
    with open(doc_idx_to_id_file, "wb") as f:
        pickle.dump(doc_idx_to_id, f)
    return doc_id_to_idx, collection


def build_topics(
    manual_topics_file: str,
    out_topics_file: str,
    out_raw_queries_file: str,
    out_manual_queries_file: str,
    out_pseudo_qrels_file: str,
    doc_id_to_idx: Dict[str, int],
    collection: Dict[int, str],
) -> List[dict]:
    def get_text_by_raw_id(raw_id: str) -> Tuple[str, int]:
        new_id = doc_id_to_idx[raw_id]
        if new_id not in collection:
            raise ValueError("Unknown document")
        return collection[new_id], new_id

    with open(manual_topics_file) as f:
        manual_raw = json.load(f)

    records: List[dict] = []
    fold_of_topic: Dict[str, int] = {}
    with open(out_raw_queries_file, "w") as out_raw, open(
        out_manual_queries_file, "w"
    ) as out_manual, open(out_pseudo_qrels_file, "w") as out_qrels:
        for manual_topic in manual_raw:
            topic_number = manual_topic["number"]
            fold_of_topic[str(topic_number)] = cast21_fold(topic_number)
            inputs: List[str] = []
            manual_responses: List[str] = []
            manual_res_ids: List[str] = []
            for manual_turn in manual_topic["turn"]:
                query_number = manual_turn["number"]
                raw = manual_turn["raw_utterance"]
                inputs.append(raw)
                target = manual_turn["manual_rewritten_utterance"]
                res_id = (
                    manual_turn["canonical_result_id"]
                    + "-"
                    + str(manual_turn["passage_id"])
                )
                manual_res_ids.append(res_id)
                response, new_id = get_text_by_raw_id(res_id)
                manual_responses.append(response)
                records.append(
                    {
                        "topic_number": topic_number,
                        "query_number": query_number,
                        "input": copy.deepcopy(inputs),
                        "automatic_response_id": [],
                        "automatic_response": [],
                        "manual_response_id": copy.deepcopy(manual_res_ids),
                        "manual_response": copy.deepcopy(manual_responses),
                        "target": target,
                    }
                )
                out_qrels.write(
                    f"{topic_number}_{query_number}\t0\t{new_id}\t1\n"
                )
                out_raw.write(f"{topic_number}_{query_number}\t{raw}\n")
                out_manual.write(f"{topic_number}_{query_number}\t{target}\n")

    write_topics_with_folds(records, out_topics_file, fold_of_topic)
    return records


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kilt", type=str)
    parser.add_argument("--msmarco", type=str)
    parser.add_argument("--wapo", type=str)
    parser.add_argument("--cast_dir", type=str)
    parser.add_argument("--out_data_dir", type=str)
    parser.add_argument("--out_collection_dir", type=str)
    args = parser.parse_args(argv)

    os.makedirs(args.out_data_dir, exist_ok=True)
    os.makedirs(args.out_collection_dir, exist_ok=True)
    doc_id_to_idx, collection = build_collection(
        [args.kilt, args.msmarco, args.wapo],
        os.path.join(args.out_collection_dir, "collection.tsv"),
        os.path.join(args.out_collection_dir, "doc_id_to_idx.pickle"),
        os.path.join(args.out_collection_dir, "doc_idx_to_id.pickle"),
    )
    build_topics(
        os.path.join(args.cast_dir, "2021_manual_evaluation_topics_v1.0.json"),
        os.path.join(args.out_data_dir, "eval_topics.jsonl"),
        os.path.join(args.out_data_dir, "queries.raw.tsv"),
        os.path.join(args.out_data_dir, "queries.manual.tsv"),
        os.path.join(args.out_data_dir, "qrels.tsv"),
        doc_id_to_idx,
        collection,
    )


if __name__ == "__main__":
    main()
