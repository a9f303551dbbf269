"""The plain search: exact inner-product top-k over the corpus, block by
block, and the exact score of any given rows. Each block comes from a
callable, so the caller can make it again from the seed."""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

Block = Tuple[int, torch.Tensor]  # (first row, rows [n, D] f32)


def exact_topk_and_scores(q: torch.Tensor, blocks: Iterable[Callable[[], Block]], k: int,
                          rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best scores [Q, k] desc, their rows [Q, k], the scores of ``rows``
    [Q, m]): one pass over the blocks. A row of ``rows`` outside the corpus
    scores NaN."""
    best_s = best_i = None
    given = torch.full(rows.shape, float("nan"), device=q.device)
    for make in blocks:
        lo, blk = make()
        s = q @ blk.T
        s_top, i_top = torch.topk(s, min(k, s.shape[1]), dim=1)
        i_top = i_top + lo
        if best_s is not None:
            s_top, sel = torch.topk(torch.cat([best_s, s_top], 1), k, dim=1)
            i_top = torch.gather(torch.cat([best_i, i_top], 1), 1, sel)
        best_s, best_i = s_top, i_top
        inside = (rows >= lo) & (rows < lo + blk.shape[0])
        local = (rows - lo).clamp(0, blk.shape[0] - 1)
        picked = torch.einsum("qd,qmd->qm", q, blk[local])
        given = torch.where(inside, picked, given)
        del s, blk
    return best_s, best_i, given
