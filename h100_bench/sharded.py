"""One rank of the sharded search cells: the corpus row-sharded over the
ranks of an ``("index",)`` mesh, one shard on each card, searched as
``drivers/run_convdr_inference.py`` searches a sharded flat index.

Each rank makes its shard on its own card from the seed: shard ``s`` holds
the global rows ``[s * rows, (s + 1) * rows)`` (``rows`` the
configuration's ``corpus_rows``; rows past the corpus are masked by
``valid_rows``), in blocks of ``block_rows`` rows, block ``b`` from the
generator of the global block index ``s * blocks + b``, so shard 0 is the
one-card cells' corpus row for row. A call, on every rank alike: the
query encode data-parallel over the mesh
(``trainer.make_query_encode_fn``: each rank encodes its slice, the rows
all-gathered), the local exact top-k of its shard
(``sharded_search.local_flat_ip_topk``), then the ``all_gather`` of the
top-k lists and ``merge_shard_topk`` (``sharded_search.gather_and_merge``).

Rank 0 runs in the harness's process and drives the others by a broadcast
command before each step (:data:`CALL`, :data:`CHECK`, :data:`CONTROL`,
:data:`EXIT`);
ranks 1..n-1 are spawned processes that run :func:`follower`. The check
runs the plain exact search shard by shard, each rank on its own shard,
and rank 0 merges the per-shard lists in plain torch.
"""

from __future__ import annotations

import datetime
import gc
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from h100_bench import traffic, weights
from h100_bench.reference.search import exact_topk_and_scores

CALL, CHECK, CONTROL, EXIT = 1, 2, 3, 4
TIMEOUT = datetime.timedelta(seconds=600)  # a collective's wait for the other ranks


def shape(cfg: dict, n_shards: int):
    """(rows a shard, the corpus's rows, blocks a shard)."""
    rows = cfg["corpus_rows"]
    n = min(cfg["corpus_rows_published"], rows * n_shards)
    return rows, n, -(-rows // cfg["block_rows"])


def shard_blocks(cfg: dict):
    """(first local row, rows) of each generator's block of a shard."""
    rows, step = cfg["corpus_rows"], cfg["block_rows"]
    return [(lo, min(step, rows - lo)) for lo in range(0, rows, step)]


@torch.no_grad()
def shard_block(cfg: dict, seed: int, shard: int, b: int, device, n_shards: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block ``b`` of shard ``shard``: N(0, 1) f32 rows from the generator
    of its global block index."""
    _rows, _n, per = shape(cfg, n_shards)
    _lo, rows = shard_blocks(cfg)[b]
    g = weights.generator(device, seed, weights.CORPUS, shard * per + b)
    kw = {} if out is None else {"out": out}
    return torch.randn((rows, cfg["embedding_dim"]), generator=g, device=device, **kw)


@torch.no_grad()
def make_shard(cfg: dict, seed: int, shard: int, device, n_shards: int) -> torch.Tensor:
    out = torch.empty((cfg["corpus_rows"], cfg["embedding_dim"]), device=device)
    for b, (lo, rows) in enumerate(shard_blocks(cfg)):
        shard_block(cfg, seed, shard, b, device, n_shards, out=out[lo:lo + rows])
    return out


@dataclass
class Rank:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    mesh: object
    shard_id: int
    n_shards: int
    queries: traffic.Queries
    encode: object = None
    shard: Optional[torch.Tensor] = None
    next_call: int = 0

    def command(self, cmd: int = 0) -> int:
        """Rank 0's command, broadcast to every rank."""
        t = torch.tensor([cmd], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return int(t.item())

    def call(self):
        """The next call of the loop on this rank -> (index, scores, rows)
        [Q, k] on the device, the same on every rank."""
        from convdr_torch.parallel.sharded_search import gather_and_merge, local_flat_ip_topk

        i = self.next_call
        self.next_call += 1
        ids, mask = self.queries.call(i, self.mix["queries_per_call"])
        dev = self.device
        q = self.encode(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
        k = self.cfg["top_k"]
        _rows, n, _per = shape(self.cfg, self.n_shards)
        s, r = local_flat_ip_topk(q, self.shard, k, self.shard_id, self.n_shards,
                                  valid_rows=n, block_rows=self.cfg["block_rows"],
                                  precision=self.cfg["matmul_precision"])
        s, r = gather_and_merge(self.mesh, "index", s, r, k)
        return i, s, r

    def check_part(self, q_ref: torch.Tensor, prog_rows: torch.Tensor):
        """This rank's plain exact search of its shard for ``q_ref`` [S, D]:
        (best scores [S, k], their global rows, the exact scores of
        ``prog_rows`` [S, k] that lie in this shard, NaN elsewhere); the
        program's shard is freed first."""
        self.shard = self.encode = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rows, n, _per = shape(self.cfg, self.n_shards)
        base = self.shard_id * rows

        def maker(b, lo):
            def make():
                blk = shard_block(self.cfg, self.seed, self.shard_id, b, self.device,
                                  self.n_shards)
                valid = max(0, min(blk.shape[0], n - base - lo))  # rows past the corpus
                return base + lo, blk[:valid]
            return make

        makers = [maker(b, lo) for b, (lo, _r) in enumerate(shard_blocks(self.cfg))]
        return exact_topk_and_scores(q_ref, makers, self.cfg["top_k"], prog_rows)


def build_rank(cfg: dict, mix: dict, seed: int, device: torch.device) -> Rank:
    """This rank's program: the mesh over every rank, its shard, the model
    and its data-parallel query encode, warmed up by the mix's calls."""
    from h100_bench import program
    from convdr_torch.parallel.mesh import get_mesh
    from convdr_torch.train.trainer import make_query_encode_fn

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    mesh = get_mesh(("index",))
    n_shards, shard_id = dist.get_world_size(), dist.get_rank()
    queries = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"], seed)
    model = program.build_model(cfg, weights.make_weights(cfg, seed, device), device)
    rank = Rank(cfg, mix, seed, device, mesh, shard_id, n_shards, queries,
                encode=make_query_encode_fn(model, mesh=mesh, data_axis="index"),
                shard=make_shard(cfg, seed, shard_id, device, n_shards))
    for _ in range(mix["warmup_calls"]):
        rank.call()
    return rank


def check_rank(rank: Rank, q: torch.Tensor, prog_rows: torch.Tensor, tf32: bool = False):
    """On every rank: ``q`` [S, D] and ``prog_rows`` [S, k] broadcast from
    rank 0, each rank's :meth:`Rank.check_part` (its products in TF32 with
    ``tf32``, the control's), all gathered and merged in plain torch: (the
    best scores [S, k], their global rows, the exact scores of the
    program's rows)."""
    import contextlib

    from h100_bench import checks

    dist.broadcast(q, src=0)
    dist.broadcast(prog_rows, src=0)
    with checks.tf32() if tf32 else contextlib.nullcontext():
        s, r, given = rank.check_part(q, prog_rows)
    n = rank.n_shards

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous())
        return parts

    best, sel = torch.topk(torch.cat(gather(s), dim=1), rank.cfg["top_k"], dim=1)
    best_rows = torch.gather(torch.cat(gather(r), dim=1), 1, sel)
    stacked = torch.stack(gather(given))
    found = ~torch.isnan(stacked)
    given = torch.where(found.any(0), torch.nan_to_num(stacked, nan=0.0).sum(0),
                        torch.full_like(given, float("nan")))
    return best, best_rows, given


def follower(cfg: dict, mix: dict, seed: int) -> None:
    """A spawned rank (1..n-1): build, then follow rank 0's commands."""
    device = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    rank = build_rank(cfg, mix, seed, device)
    k = cfg["top_k"]
    while True:
        cmd = rank.command()
        if cmd == CALL:
            rank.call()
        elif cmd in (CHECK, CONTROL):
            q = torch.empty((mix["check_rows"], cfg["embedding_dim"]), device=device)
            prog_rows = torch.empty((mix["check_rows"], k), dtype=torch.int64, device=device)
            check_rank(rank, q, prog_rows, tf32=cmd == CONTROL)
        else:
            return


def sample_rows(mix: dict, queries: traffic.Queries, seed: int, n_calls: int, first: int = 0):
    """(pool rows, their (call, row-in-call) places) of the check's sample
    among ``n_calls`` calls from call ``first``: a seeded draw of
    ``check_requests`` and the longest query among them, padded to
    ``check_rows`` with repeats of the first."""
    per = mix["queries_per_call"]
    pool = len(queries.valid) // per
    flat = [(c, j) for c in range(first, first + n_calls) for j in range(per)]
    rows = np.array([(c % pool) * per + j for c, j in flat])
    g = traffic.rng(seed, traffic.SAMPLE)
    pick = set(g.choice(len(flat), size=min(mix["check_requests"], len(flat)),
                        replace=False).tolist())
    pick.add(int(np.argmax(queries.valid[rows])))
    pick = sorted(pick)
    pick += [pick[0]] * (mix["check_rows"] - len(pick))
    return rows[pick], [flat[p] for p in pick]
