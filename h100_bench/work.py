"""The yardstick: the work of each function the cells time, counted from
its shapes, and the chip's published peaks.

A kernel's count is the function's, never a design's: each input read once
and each output written once, the operations of the mathematics, and only
what the inputs need (an attention's valid query-key pairs, a sequence's
valid tokens). So a redesign that computes the same function faster reads
higher, and none can read over its roofline.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    """NVIDIA's published H100 SXM peaks (``peaks.json``)."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


class Work:
    """Operations and bytes; ``least_s`` is the time the chip needs at
    least: the larger of operations at the bf16 tensor-core peak and bytes
    at the memory bandwidth."""

    def __init__(self, flops: float = 0.0, bytes_: float = 0.0):
        self.flops, self.bytes = float(flops), float(bytes_)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.flops * n, self.bytes * n)

    def least_s(self, pk: dict) -> float:
        return max(self.flops / pk["bf16_flops_per_s"], self.bytes / pk["hbm_bytes_per_s"])


def encoder_flops(cfg: dict, valid: Iterable[int]) -> float:
    """Matmul operations of one encoder forward over sequences of ``valid``
    tokens each: the Q, K, V and output projections, the scores and the
    probabilities times values over valid pairs, the feed-forward pair, and
    the ANCE head on the pooled token. Embedding lookups and LayerNorms
    are left out (bandwidth, not operations)."""
    h, i, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    head = 2 * h * cfg["embedding_dim"] if cfg["head"] == "linear_layernorm" else 0
    total = 0.0
    for n in valid:
        total += layers * (8 * n * h * h + 4 * n * n * h + 4 * n * h * i) + head
    return float(total)


def attention_fwd(cfg: dict, valid: Iterable[int], elem: int, with_lse: bool = False) -> Work:
    """One layer's attention forward over sequences of ``valid`` tokens:
    4 H D operations a valid query-key pair; q, k, v read and the output
    (and each row's log-sum-exp) written once over the valid tokens."""
    hd, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    w = Work()
    for n in valid:
        w = w + Work(4 * n * n * hd, 4 * n * hd * elem + (4 * n * heads if with_lse else 0))
    return w


def attention_bwd(cfg: dict, valid: Iterable[int], elem: int) -> Work:
    """One layer's attention backward from q, k, v, the output, its
    gradient and the log-sum-exp: the probabilities again from q k (2 H D
    a valid pair), then dP, dV, dK and dQ (2 H D each); five inputs and the
    log-sum-exp read, three gradients written, over the valid tokens."""
    hd, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    w = Work()
    for n in valid:
        w = w + Work(10 * n * n * hd, 8 * n * hd * elem + 4 * n * heads)
    return w


def scores(q: int, rows: int, dim: int, group: int, p_elem: int = 4) -> Work:
    """Kernel 2's function over ``rows`` corpus rows: the [Q, rows] scores
    and their maxima over groups of ``group`` rows, f32 out; the rows and
    the f32 queries read once."""
    return Work(2.0 * q * rows * dim,
                rows * dim * p_elem + q * dim * 4 + q * rows * 4 + q * (rows // group) * 4)


def search(q: int, rows: int, dim: int, p_elem: int = 4) -> Work:
    """An exact top-k over the corpus: every row read once and scored; the
    k results are negligible."""
    return Work(2.0 * q * rows * dim, rows * dim * p_elem)
