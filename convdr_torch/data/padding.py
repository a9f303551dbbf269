"""Padding / truncation helpers for fixed-shape batches.

Semantics match reference utils/util.py:146-185 (``pad_input_ids`` /
``pad_input_ids_with_mask``): right-pad with ``pad_token`` (default 0) and
truncate over-length sequences; a truncated sequence has an all-ones mask.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def pad_input_ids(
    input_ids: Sequence[int],
    max_length: int,
    pad_token: int = 0,
) -> List[int]:
    ids = list(input_ids)
    if len(ids) >= max_length:
        return ids[:max_length]
    return ids + [pad_token] * (max_length - len(ids))


def pad_input_ids_with_mask(
    input_ids: Sequence[int],
    max_length: int,
    pad_token: int = 0,
) -> Tuple[List[int], List[int]]:
    ids = list(input_ids)
    if len(ids) >= max_length:
        return ids[:max_length], [1] * max_length
    n = len(ids)
    mask = [1] * n + [0] * (max_length - n)
    return ids + [pad_token] * (max_length - n), mask
