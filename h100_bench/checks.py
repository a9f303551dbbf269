"""The comparison that decides ``correct``: numbers of the program's outputs
against the plain reference, each held to its limit in
``limits/<cell>.json``.

Search cells (``OnlineSearcher.search_tokens``: scores and rows of the
top-k), over a sample of the window's queries drawn from the seed, the
longest query among them. Each score is measured in units of
``|q_ref| sqrt(D)``, about ``|q| |p|`` for the corpus's N(0, 1) rows:

  * ``score_gap``: the widest gap between a score the program returned and
    the reference's exact score of the same row;
  * ``rank_gap``: the widest margin by which the exact score of the
    program's k-th row lies below the reference's k-th best score (a row
    that only swapped with a near tie reads about its rounding);
  * ``bad_rows``: rows outside the corpus, repeated within a query, or
    missing; an exact count with the limit 0.

Training cells (the first ``checked_steps`` steps of the program's step,
against the plain step on the same batches). A leaf's gap is the distance
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and its median leaf's:

  * ``loss_gap``: the relative gap of the first step's loss (the later
    steps' losses are held through ``update_gap``: each is a small
    difference of large logits, and Adam's first updates turn the
    rounding of near-zero gradients into whole steps, so their gaps swing
    from seed to seed; ``PERF.md`` gives both readings);
  * ``grad_gap``: the widest leaf gap of the first step's clipped gradient,
    which the program's Adam state holds as ``mu / (1 - b1)``;
  * ``update_gap``: the median leaf's gap of the parameters' change over
    the checked steps, leaving out the leaves whose first reference
    gradient is under a thousandth of the median leaf's (they move by
    round-off alone, as a key's bias under softmax does). The median, not
    the widest: a few small leaves' changes swing with the rounding of
    their near-zero gradient elements, which Adam's first steps normalize
    to whole steps (``PERF.md`` gives both readings).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
B1 = 0.9
TINY_GRAD = 1e-3


@contextlib.contextmanager
def tf32():
    """TF32 products inside the block (the controls' precision), the
    previous setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def load_limits(cell: str, root: str = HERE) -> Dict[str, float]:
    with open(os.path.join(root, "limits", f"{cell}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number with no limit, or a NaN,
    fails."""
    out = {}
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def search_numbers(prog_scores: torch.Tensor, prog_rows: torch.Tensor, q_ref: torch.Tensor,
                   ref_scores: torch.Tensor, given_scores: torch.Tensor,
                   n_rows: int) -> Dict[str, float]:
    """The search cells' numbers: ``prog_*`` [S, k] the program's answers
    to S sampled queries, ``q_ref`` [S, D] their reference embeddings,
    ``ref_scores`` [S, k] the reference's best scores and ``given_scores``
    [S, k] its exact scores of the program's rows."""
    k = ref_scores.shape[1]
    unit = torch.linalg.vector_norm(q_ref, dim=1, keepdim=True) * q_ref.shape[1] ** 0.5
    rows = prog_rows.long()
    outside = (rows < 0) | (rows >= n_rows)
    srt, _ = torch.sort(rows, dim=1)
    repeated = torch.zeros_like(outside)
    repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
    bad = int(outside.sum() + repeated.sum()) + max(0, k - rows.shape[1]) * rows.shape[0]
    m = min(k, rows.shape[1])
    ok = ~outside[:, :m]
    score = ((prog_scores[:, :m].float() - given_scores[:, :m]).abs() / unit)[ok]
    rank = ((ref_scores[:, :m] - given_scores[:, :m]) / unit)[ok]
    return {
        "score_gap": float(score.max()) if score.numel() else float("nan"),
        "rank_gap": max(0.0, float(rank.max())) if rank.numel() else float("nan"),
        "bad_rows": float(bad),
    }


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> np.ndarray:
    """Each leaf's gap between two maps of leaf norms."""
    names = keep if keep is not None else list(ref)
    median = float(np.median([ref[n] for n in ref]))
    return np.array([abs(prog[n] - ref[n]) / max(ref[n], median) for n in names])


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Optional[List[str]] = None, n: int = 3) -> List[tuple]:
    """The ``n`` leaves with the widest gaps: (name, program, reference,
    gap); what a calibration reads to find a number's cause."""
    names = keep if keep is not None else list(ref)
    median = float(np.median([ref[k] for k in ref]))
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], median), k) for k in names),
                  reverse=True)[:n]
    return [(k, prog[k], ref[k], g) for g, k in gaps]


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose first reference gradient is a thousandth of the
    median leaf's or more: the ones the change is compared on."""
    median = float(np.median(list(ref_grad.values())))
    return [n for n, g in ref_grad.items() if g >= TINY_GRAD * median]


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_grad: Dict[str, float], ref_grad: Dict[str, float],
                  prog_change: Dict[str, float], ref_change: Dict[str, float]) -> Dict[str, float]:
    """The training cells' numbers from per-step losses and per-leaf norms
    (gradients: the first step's clipped gradient; change: the parameters'
    after the checked steps)."""
    return {
        "loss_gap": abs(prog_losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "grad_gap": float(leaf_gaps(prog_grad, ref_grad).max()),
        "update_gap": float(np.median(leaf_gaps(prog_change, ref_change,
                                                moving_leaves(ref_grad)))),
    }


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's norm, read back in one copy."""
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].detach().float())
                          for n in names]).tolist()
    return dict(zip(names, values))
