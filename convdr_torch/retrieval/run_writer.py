"""Run outputs: TREC run files and OpenMatch rerank jsonl.

Byte-compatible with the reference's ``EvalDevQuery`` writers
(reference drivers/run_convdr_inference.py:21-113):

  * dedup: a pid surfacing from several chunk rows keeps its best rank
    (:58-69, ``seen_pid``);
  * offsets map to pids through ``offset2pid`` (:59);
  * qrels labels are attached to every OpenMatch line (:98-100);
  * TREC line: ``qid Q0 pid rank score ance`` with the reference's
    rank-derived score ``200 - rank`` (:111-113);
  * OpenMatch jsonl fields: query/doc/label/query_id/doc_id/
    retrieval_score/input (:101-110).

Also returns the run as ``{qid: [(pid, retrieval_score), ...]}`` for the
in-process metrics (:mod:`convdr_torch.evaluation.metrics`), which the
reference could not compute without the external trec_eval binary.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


def dedup_ranked_candidates(
    scores: Sequence[float],
    offsets: Sequence[int],
    offset2pid: Sequence[int],
    top_n: int,
    *,
    pad_to_top_n: bool = True,
) -> List[Tuple[int, float]]:
    """Offsets -> pids with best-rank dedup; result ranked, top_n long.

    ``pad_to_top_n`` replicates the reference exactly: EvalDevQuery
    preallocates ``[(0, 0)] * topN`` (run_convdr_inference.py:52) and writes
    all topN lines even when dedup leaves fewer unique pids, so short lists
    pad with (pid 0, score 0) placeholder rows.
    """
    seen = set()
    out: List[Tuple[int, float]] = []
    for score, offset in zip(scores, offsets):
        if offset < 0:
            continue
        pid = offset2pid[offset]
        if pid in seen:
            continue
        seen.add(pid)
        out.append((pid, float(score)))
        if len(out) >= top_n:
            break
    if pad_to_top_n:
        out.extend([(0, 0.0)] * (top_n - len(out)))
    return out


def build_run(
    qids: Sequence[str],
    scores,  # [Q, top_n]
    offsets,  # [Q, top_n]
    offset2pid: Sequence[int],
    top_n: int,
) -> Dict[str, List[Tuple[int, float]]]:
    """Per-query ranked (pid, score) lists. A qid appearing twice keeps its
    first occurrence (reference behavior, run_convdr_inference.py:49-55)."""
    run: Dict[str, List[Tuple[int, float]]] = {}
    for row, qid in enumerate(qids):
        qid = str(qid)
        if qid in run:
            continue
        run[qid] = dedup_ranked_candidates(
            scores[row], offsets[row], offset2pid, top_n
        )
    return run


def write_trec_run(
    run: Mapping[str, Sequence[Tuple[int, float]]],
    path: str,
    *,
    tag: str = "ance",
) -> None:
    """TREC format with the reference's rank-derived score column
    (run_convdr_inference.py:111-113)."""
    with open(path, "w") as g:
        for qid, ranked in run.items():
            for i, (pid, _score) in enumerate(ranked):
                g.write(f"{qid} Q0 {pid} {i + 1} {-i - 1 + 200} {tag}\n")


def write_openmatch_jsonl(
    run: Mapping[str, Sequence[Tuple[int, float]]],
    path: str,
    *,
    queries: Mapping[str, str],
    collection,
    qrels: Optional[Mapping[str, Mapping[int, int]]] = None,
    raw_sequences: Optional[Mapping[str, Sequence[str]]] = None,
) -> None:
    qrels = qrels or {}
    raw_sequences = {str(k): v for k, v in (raw_sequences or {}).items()}
    queries = {str(k): v for k, v in queries.items()}
    with open(path, "w") as f:
        for qid, ranked in run.items():
            query_text = queries[qid]
            inputs = raw_sequences.get(qid)
            for pid, score in ranked:
                label = qrels.get(qid, {}).get(pid, 0)
                f.write(
                    json.dumps(
                        {
                            "query": query_text,
                            "doc": collection[pid],
                            "label": label,
                            "query_id": str(qid),
                            "doc_id": str(pid),
                            "retrieval_score": score,
                            "input": inputs,
                        }
                    )
                    + "\n"
                )


def write_run_outputs(
    qids: Sequence[str],
    scores,
    offsets,
    offset2pid: Sequence[int],
    top_n: int,
    *,
    output_trec_file: Optional[str] = None,
    output_file: Optional[str] = None,
    queries: Optional[Mapping[str, str]] = None,
    collection=None,
    qrels: Optional[Mapping[str, Mapping[int, int]]] = None,
    raw_sequences: Optional[Mapping[str, Sequence[str]]] = None,
) -> Dict[str, List[Tuple[int, float]]]:
    """One-call equivalent of EvalDevQuery: build run, write both outputs."""
    run = build_run(qids, scores, offsets, offset2pid, top_n)
    if output_trec_file:
        write_trec_run(run, output_trec_file)
    if output_file:
        if queries is None or collection is None:
            raise ValueError("OpenMatch output needs queries and collection")
        write_openmatch_jsonl(
            run,
            output_file,
            queries=queries,
            collection=collection,
            qrels=qrels,
            raw_sequences=raw_sequences,
        )
    return run
