"""Row-sharded exact, IVF and PQ retrieval: a local search on each rank, an
``all_gather`` of the per-shard top-k lists, and a stable merge.

The counterpart of ``convdr_tpu/parallel/sharded_search.py`` (the reference
shards its flat index inside FAISS, run_convdr_inference.py:355-368). Each
rank holds one shard of the ``index`` axis: the rows ``[shard * rows,
(shard + 1) * rows)`` of a matrix padded to ``n_shards * rows`` rows, or its
``L_pad / n_shards`` IVF sub-lists. Each search is split in two:

  * a local search (``local_*_topk``) that takes ``(shard_id, n_shards)``
    and returns ``(scores [Q, k], global indices [Q, k])``, NEG_INF / -1
    padded; it runs the port's single-device search on the shard, so on
    the card the flat one launches the score kernel and the gather kernel
    (``csrc/scores_groupmax.cu``, ``csrc/gather_groups.cu``) for its rows;
  * :func:`merge_shard_topk`, a pure function of the gathered ``[S, Q, k]``
    lists in shard order.

The distributed functions are the local search, ``dist.all_gather`` over
``mesh.get_group(axis)`` and the merge; every rank returns the same result.
Ties: shard 0 holds the lowest global rows and comes first in the merged
candidates, and the merge is a stable descending sort, so equal scores go
to the lower global row, as ``jax.lax.top_k`` orders the JAX package's
shard-ordered concatenation. Running the local search for every shard in
one process and merging gives the same result with no collective.
"""

from __future__ import annotations

from typing import Tuple

import torch

from convdr_torch.ops.exact_search import NEG_INF, flat_ip_topk, stable_topk
from convdr_torch.ops.pq import pq_flat_topk
from convdr_torch.parallel.mesh import all_gather_rows, axis_index, axis_size
from convdr_torch.retrieval.ivf import MAX_CANDIDATE_BYTES, _ivf_search_dev
from convdr_torch.utils.observability import span


def merge_shard_topk(
    all_s: torch.Tensor, all_i: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists ``[S, Q, k']`` (shard order) into the
    top ``k``: the candidates of shard 0 first, then a stable descending
    sort, so ties go to the earlier shard, i.e. the lower global row."""
    qn = all_s.shape[1]
    cat_s = all_s.transpose(0, 1).reshape(qn, -1)
    cat_i = all_i.transpose(0, 1).reshape(qn, -1)
    top_s, sel = stable_topk(cat_s, k)
    return top_s, torch.gather(cat_i, 1, sel)


def gather_and_merge(mesh, axis: str, s: torch.Tensor, i: torch.Tensor, k: int):
    """Every rank's local top-k along ``axis``, merged (the same on every
    rank); the span ``convdr.shard.gather_merge`` while a profiler runs."""
    with span("convdr.shard.gather_merge"):
        return merge_shard_topk(all_gather_rows(mesh, axis, s),
                                all_gather_rows(mesh, axis, i), k)


def _to_global(s: torch.Tensor, i: torch.Tensor, base: int):
    """Local rows -> global rows; invalid slots (NEG_INF, -1)."""
    ok = i >= 0
    return s.masked_fill(~ok, NEG_INF), torch.where(ok, i + base, -1)


def _local_valid(valid_rows: int, rows: int, shard_id: int, n_shards: int) -> int:
    """Valid rows of this shard: the corpus's first ``valid_rows`` global
    rows (all of them when negative), clipped to the shard."""
    valid = rows * n_shards if valid_rows < 0 else valid_rows
    return min(max(valid - shard_id * rows, 0), rows)


def local_flat_ip_topk(
    queries: torch.Tensor,
    passage_shard: torch.Tensor,
    k: int,
    shard_id: int,
    n_shards: int,
    *,
    valid_rows: int = -1,
    block_rows: int = 65536,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of one shard ``[rows, D]`` of a row-sharded matrix, as
    (scores, global row indices); a shard with no valid rows returns only
    -1."""
    rows = passage_shard.shape[0]
    s, i = flat_ip_topk(
        queries, passage_shard, k, block_rows=min(block_rows, rows),
        valid_rows=_local_valid(valid_rows, rows, shard_id, n_shards),
        precision=precision,
    )
    return _to_global(s, i, shard_id * rows)


def sharded_flat_ip_topk(
    mesh,
    queries: torch.Tensor,
    passage_shards: torch.Tensor,
    k: int,
    *,
    valid_rows: int = -1,
    block_rows: int = 65536,
    axis: str = "index",
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a row-sharded passage matrix; returns the same (scores, idx)
    on every rank.

    queries        [Q, D]     the same on every rank
    passage_shards [rows, D]  this rank's shard of the padded [S * rows, D]
                              matrix (every rank holds ``rows`` rows)
    valid_rows     logical corpus size before padding (-1 => S * rows)

    Output indices are global rows in [0, valid_rows) or -1.
    """
    s, i = local_flat_ip_topk(
        queries, passage_shards, k, axis_index(mesh, axis), axis_size(mesh, axis),
        valid_rows=valid_rows, block_rows=block_rows, precision=precision,
    )
    return gather_and_merge(mesh, axis, s, i, k)


def local_ivf_topk(
    q_probe: torch.Tensor,
    q_score: torch.Tensor,
    centroids: torch.Tensor,
    lists: torch.Tensor,
    rowids: torch.Tensor,
    k: int,
    nprobe: int,
    n_shards: int,
    *,
    exact: bool = False,
    packed: bool = False,
    max_candidate_bytes: int = MAX_CANDIDATE_BYTES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF top-k over one shard's sub-lists (``centroids [L_local, D]``,
    ``lists [L_local, cap, d]``, ``rowids [L_local, cap]``, pad sub-lists
    with a zero centroid and rowids -1). The probe allocation is forced
    balanced: ``max(1, min(ceil(nprobe / n_shards), L_local))`` local
    sub-lists a query. Row ids are global already. int8 lists score in f32
    on their int values, which equals the JAX package's bf16 product with
    f32 accumulation: int8 values and int-valued queries in [-127, 127] are
    exact in bf16, and so are their products and sums."""
    nprobe_local = max(1, min(-(-nprobe // n_shards), lists.shape[0]))
    return _ivf_search_dev(
        q_probe, q_score, centroids, lists, rowids, k, nprobe_local,
        exact=exact, packed=packed, max_candidate_bytes=max_candidate_bytes,
    )


def sharded_ivf_topk(
    mesh,
    q_probe: torch.Tensor,
    q_score: torch.Tensor,
    centroids: torch.Tensor,
    lists: torch.Tensor,
    rowids: torch.Tensor,
    k: int,
    nprobe: int,
    *,
    axis: str = "index",
    packed: bool = False,
    exact: bool = False,
    max_candidate_bytes: int = MAX_CANDIDATE_BYTES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF search over sub-lists sharded on the ``axis`` mesh dim (FAISS's
    per-GPU IVF shards): each rank probes its balanced share of ``nprobe``
    among its own sub-lists (:func:`local_ivf_topk`) and the per-shard lists
    merge as in :func:`sharded_flat_ip_topk`. The probed set can differ from
    the single-device index's global top-``nprobe`` (recall comparable, not
    identical); with ``nprobe >= L`` every row is scored on some shard and
    the result set is the exact one. PQ-code lists score with the
    bf16-rounded LUT, as the JAX package's sharded search does, unless
    ``exact``."""
    s, i = local_ivf_topk(
        q_probe, q_score, centroids, lists, rowids, k, nprobe, axis_size(mesh, axis),
        exact=exact, packed=packed, max_candidate_bytes=max_candidate_bytes,
    )
    return gather_and_merge(mesh, axis, s, i, k)


def local_pq_topk(
    lut: torch.Tensor,
    code_shard: torch.Tensor,
    k: int,
    ksub: int,
    shard_id: int,
    n_shards: int,
    *,
    valid_rows: int = -1,
    block_rows: int = 1 << 18,
    exact: bool = False,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k of one shard ``[rows, M]`` (``[rows, M/2]`` packed) of
    row-sharded PQ codes, as (scores, global row indices)."""
    rows = code_shard.shape[0]
    s, i = pq_flat_topk(
        lut, code_shard, k, ksub, block_rows=min(block_rows, rows),
        valid_rows=_local_valid(valid_rows, rows, shard_id, n_shards),
        exact=exact, packed=packed,
    )
    return _to_global(s, i, shard_id * rows)


def sharded_pq_topk(
    mesh,
    lut: torch.Tensor,
    code_shards: torch.Tensor,
    k: int,
    ksub: int,
    *,
    valid_rows: int = -1,
    block_rows: int = 1 << 18,
    axis: str = "index",
    exact: bool = False,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC search over row-sharded PQ codes; returns the same (scores, idx)
    on every rank.

    lut         [Q, M, K] f32  the same on every rank
    code_shards [rows, M] u8   this rank's shard of the padded codes
                ([rows, M/2] with ``packed=True``, nbits=4 nibbles)
    valid_rows  logical corpus size before padding (-1 => S * rows)
    """
    s, i = local_pq_topk(
        lut, code_shards, k, ksub, axis_index(mesh, axis), axis_size(mesh, axis),
        valid_rows=valid_rows, block_rows=block_rows, exact=exact, packed=packed,
    )
    return gather_and_merge(mesh, axis, s, i, k)
