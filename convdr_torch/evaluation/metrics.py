"""In-process IR metrics with trec_eval conventions.

The reference delegates quality evaluation to the external ``trec_eval``
binary (reference README.md:207) and ships no metric code; pytrec_eval
is declared (requirements.txt:3) but never invoked. This module computes the
headline metrics in-process from the same inputs (a TREC run + qrels):

  * NDCG@k  -- trec_eval ``ndcg_cut.k`` convention: linear gain
    ``rel / log2(rank+1)``, ideal ranking from all judged docs;
  * MRR     -- reciprocal rank of the first doc with rel > 0 (OR-QuAC
    headline metric);
  * Recall@k -- judged-relevant retrieved in top-k / total relevant;
  * MAP     -- mean average precision over rel > 0 docs.

Inputs mirror the framework's native structures: a run is
``{qid: [(pid, score), ...]}`` ranked best-first, qrels is
``{qid: {pid: rel}}`` (from :func:`convdr_torch.data.collection.load_qrels`).
Only queries present in the qrels contribute, and — matching trec_eval's
``num_q`` accounting — a judged query with NO rel>0 document is excluded
from evaluation entirely rather than contributing zeros (trec_eval skips
num_rel==0 topics; ``load_qrels`` additionally never creates such topics,
reproducing the reference loader's first-positive-line quirk).

The conventions are pinned by committed golden fixtures with hand-derived
expected values: ``tests/fixtures/metrics_golden/`` (see DERIVATION.md
there for the worked arithmetic straight from trec_eval's documented
formulas).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

Run = Mapping[str, Sequence[Tuple[int, float]]]
Qrels = Mapping[str, Mapping[int, int]]


def ndcg_at_k(ranked_pids: Sequence[int], rels: Mapping[int, int], k: int) -> float:
    gains = [max(rels.get(pid, 0), 0) for pid in ranked_pids[:k]]
    dcg = sum(g / math.log2(i + 2) for i, g in enumerate(gains))
    ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
    idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def mrr(ranked_pids: Sequence[int], rels: Mapping[int, int], k: int = 0) -> float:
    limit = len(ranked_pids) if k <= 0 else min(k, len(ranked_pids))
    for i in range(limit):
        if rels.get(ranked_pids[i], 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def recall_at_k(ranked_pids: Sequence[int], rels: Mapping[int, int], k: int) -> float:
    relevant = {pid for pid, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    hit = sum(1 for pid in ranked_pids[:k] if pid in relevant)
    return hit / len(relevant)


def average_precision(ranked_pids: Sequence[int], rels: Mapping[int, int]) -> float:
    relevant = {pid for pid, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    hits, ap = 0, 0.0
    for i, pid in enumerate(ranked_pids):
        if pid in relevant:
            hits += 1
            ap += hits / (i + 1)
    return ap / len(relevant)


def evaluate_run(
    run: Run,
    qrels: Qrels,
    *,
    ndcg_cuts: Sequence[int] = (3,),
    recall_cuts: Sequence[int] = (100,),
) -> Dict[str, Dict[str, float]]:
    """Per-query metrics for every run query that has qrels."""
    out: Dict[str, Dict[str, float]] = {}
    for qid, ranked in run.items():
        rels = qrels.get(str(qid))
        if not rels or not any(r > 0 for r in rels.values()):
            # unjudged queries AND judged-but-no-relevant queries are
            # excluded (trec_eval num_q counts only num_rel>0 topics)
            continue
        pids = [pid for pid, _score in ranked]
        m: Dict[str, float] = {"mrr": mrr(pids, rels), "map": average_precision(pids, rels)}
        for k in ndcg_cuts:
            m[f"ndcg_cut_{k}"] = ndcg_at_k(pids, rels, k)
        for k in recall_cuts:
            m[f"recall_{k}"] = recall_at_k(pids, rels, k)
        out[str(qid)] = m
    return out


def mean_metrics(per_query: Mapping[str, Mapping[str, float]]) -> Dict[str, float]:
    if not per_query:
        return {}
    keys: List[str] = sorted(next(iter(per_query.values())).keys())
    n = len(per_query)
    return {k: sum(q[k] for q in per_query.values()) / n for k in keys}


def parse_trec_run(path: str) -> Dict[str, List[Tuple[int, float]]]:
    """Read a TREC run file back into run structure (rank order preserved)."""
    run: Dict[str, List[Tuple[int, float, int]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _q0, pid, rank, score = parts[0], parts[1], parts[2], int(parts[3]), float(parts[4])
            run.setdefault(qid, []).append((int(pid), score, rank))
    return {
        qid: [(pid, score) for pid, score, _r in sorted(rows, key=lambda t: t[2])]
        for qid, rows in run.items()
    }
