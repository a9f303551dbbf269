"""The sharded search cells: back-to-back calls of ``queries_per_call``
conversational queries over the whole corpus row-sharded across the
cell's cards, one ``("index",)`` mesh rank a card, as
``drivers/run_convdr_inference.py`` searches a sharded flat index
(``h100_bench/sharded.py`` holds a rank's program and the commands).

Set-up forms the process group over a ``file://`` store under ``TMPDIR``:
rank 0 in this process (the harness's device), ranks 1..n-1 spawned
(the ``spawn`` start method, as ``parallel/dryrun.py`` spawns its ranks),
each on its own card (or gloo ranks on the CPU). Every rank makes its
shard and the model from the seed and runs the warm-up calls. The window
times every call on rank 0's host clock from the call to its return with
the merged top-k on the host. The traced segment runs ``trace_calls``
more calls with rank 0 under the profiler. The check frees the program's
shards and judges a sample of the window's answers against the plain
reference: the query embeddings of the plain encoder, then the plain
exact search of each shard on its own card, merged on rank 0.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from h100_bench import checks, sharded, spantrace, weights, work
from h100_bench.reference.encoder import embed_rows


@dataclass
class State:
    rank: sharded.Rank
    procs: list
    store_dir: str
    answers: List[tuple] = field(default_factory=list)  # (call, scores, rows) on the host


def setup(ctx) -> State:
    from convdr_torch.parallel import dryrun
    from convdr_torch.parallel.mesh import init_distributed

    no_cuda = ctx.device.type != "cuda"
    n = ctx.mix["ranks"]
    store_dir = tempfile.mkdtemp(prefix="h100_bench_ranks_")
    store = os.path.join(store_dir, "store")
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=dryrun._rank_main, daemon=True,
                        args=(r, n, store, no_cuda, sharded.follower,
                              (ctx.cfg, ctx.mix, ctx.seed)))
             for r in range(1, n)]
    for p in procs:
        p.start()
    init_distributed(no_cuda, rank=0, world_size=n, local_rank=ctx.device.index or 0,
                     init_method=f"file://{store}", timeout=sharded.TIMEOUT)
    rank = sharded.build_rank(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    ctx.sync()
    return State(rank, procs, store_dir)


def call(st: State):
    st.rank.command(sharded.CALL)
    i, s, r = st.rank.call()
    return i, s.cpu().numpy(), r.cpu().numpy()


def least_s(cfg: dict, n_shards: int, pk: dict, valid) -> float:
    """The least time of one call on one card: its slice of the encoder's
    operations at the bf16 peak, then its shard's search operations or
    bytes, whichever bounds."""
    return (work.encoder_flops(cfg, valid) / n_shards / pk["bf16_flops_per_s"]
            + work.search(len(valid), cfg["corpus_rows"], cfg["embedding_dim"]).least_s(pk))


def window(ctx, st: State) -> dict:
    latency = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        i, s, r = call(st)
        b = time.perf_counter()
        latency.append(b - a)
        st.answers.append((i, s, r))
        if b - t0 >= ctx.seconds:
            break
    per = ctx.mix["queries_per_call"]
    valid = st.rank.queries.valid
    pool = len(valid) // per
    pk = work.peaks()
    least = [least_s(ctx.cfg, st.rank.n_shards, pk,
                     valid[(i % pool) * per:(i % pool + 1) * per]) for i, _s, _r in st.answers]
    return {"latency_s": latency, "window_s": b - t0, "least_s": least,
            "attempted": len(latency) * per, "units": len(latency) * per}


def traced(ctx, st: State) -> dict:
    n = ctx.mix["trace_calls"]

    def segment():
        for _ in range(n):
            call(st)

    return {"trace": spantrace.traced(segment, ctx.device)}


def check(ctx, st: State, obs: dict) -> dict:
    """Free the program; judge a sample of the window's answers (the longest
    query among them) against the plain reference, then stop the ranks."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    rank = st.rank
    first = st.answers[0][0]
    rows, places = sharded.sample_rows(mix, rank.queries, ctx.seed, len(st.answers), first)
    by_call = {i: (s, r) for i, s, r in st.answers}
    prog_s = torch.tensor(np.stack([by_call[c][0][j] for c, j in places])).to(dev)
    prog_r = torch.tensor(np.stack([by_call[c][1][j] for c, j in places])).to(dev)
    st.answers = []
    try:
        return reference_numbers(ctx, st, rows, prog_s, prog_r)
    finally:
        stop(st)


def reference_numbers(ctx, st: State, rows, prog_s, prog_r) -> dict:
    cfg, dev, rank = ctx.cfg, ctx.device, st.rank
    ids = torch.from_numpy(rank.queries.ids[rows]).to(dev)
    mask = torch.from_numpy(rank.queries.mask[rows]).to(dev)
    w = weights.make_weights(cfg, ctx.seed, dev)
    q_ref = embed_rows(w, cfg, ids, mask, "query")
    del w
    rank.command(sharded.CHECK)
    prog_r = prog_r.long().contiguous()
    ref_s, _ref_r, given = sharded.check_rank(rank, q_ref, prog_r)
    _rows, n, _per = sharded.shape(cfg, rank.n_shards)
    return checks.search_numbers(prog_s, prog_r, q_ref, ref_s, given, n)


def stop(st: State) -> None:
    """Send the ranks their exit, close the group, reap the processes."""
    if st.procs:
        st.rank.command(sharded.EXIT)
        dist.destroy_process_group()
        for p in st.procs:
            p.join(60)
            if p.is_alive():
                p.kill()
        st.procs = []
        shutil.rmtree(st.store_dir, ignore_errors=True)


def control(ctx) -> dict:
    """The control's numbers: the plain reference in TF32 (the precision
    below the configuration's f32 with TF32 off), the query embeddings and
    each shard's exact search on its card, answers as many of the pool's
    queries as a run's check samples, the longest among them; the f32
    reference judges those answers as it judges the program's."""
    st = setup(ctx)
    try:
        rank, mix, dev = st.rank, ctx.mix, ctx.device
        pool_calls = len(rank.queries.valid) // mix["queries_per_call"]
        rows, _places = sharded.sample_rows(mix, rank.queries, ctx.seed, pool_calls)
        with checks.tf32():
            w = weights.make_weights(ctx.cfg, ctx.seed, dev)
            q = embed_rows(w, ctx.cfg, torch.from_numpy(rank.queries.ids[rows]).to(dev),
                           torch.from_numpy(rank.queries.mask[rows]).to(dev), "query")
            del w
        rank.command(sharded.CONTROL)
        none = torch.zeros((len(rows), ctx.cfg["top_k"]), dtype=torch.int64, device=dev)
        s, r, _ = sharded.check_rank(rank, q, none, tf32=True)
        return reference_numbers(ctx, st, rows, s, r)
    finally:
        stop(st)
