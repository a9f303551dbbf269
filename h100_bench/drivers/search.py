"""The search cells: a closed loop of ``OnlineSearcher.search_tokens`` calls,
``queries_per_call`` conversational queries a call, over the configuration's
corpus resident on the card.

Set-up makes the weights and the corpus on the device from the seed,
builds the searcher (its first call at this Q captures the serving graph)
and warms it up. The window times every call on the host clock from the
call to its return with the top-k rows. The traced segment runs
``trace_calls`` more calls under the profiler, then times the program's
two halves alone (``OnlineSearcher.encode`` and its search closure), each
captured with the port's ``capture`` and replayed on the window's own
queries between CUDA events. The check frees the program and judges a
sample of the window's answers against the plain reference.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from h100_bench import checks, devtrace, program, traffic, weights, work
from h100_bench.reference.encoder import embed_rows
from h100_bench.reference.search import exact_topk_and_scores

GROUP = 32  # the group of kernel 2's maxima in flat_ip_topk's calls


@dataclass
class State:
    searcher: object
    queries: traffic.Queries
    next_call: int = 0
    answers: List[tuple] = field(default_factory=list)  # (call, scores, rows)


def setup(ctx) -> State:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    queries = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"],
                                           ctx.seed)
    model = program.build_model(cfg, weights.make_weights(cfg, ctx.seed, dev), dev)
    corpus = weights.make_corpus(cfg, ctx.seed, dev, program.row_tile())
    searcher = program.searcher(cfg, model, corpus, dev)
    st = State(searcher, queries)
    for _ in range(mix["warmup_calls"]):
        call(ctx, st)
    return st


def call(ctx, st: State):
    """The next call of the loop -> (its index, scores, rows)."""
    i = st.next_call
    st.next_call += 1
    ids, mask = st.queries.call(i, ctx.mix["queries_per_call"])
    s, r = st.searcher.search_tokens(ids, mask, record=False)
    return i, s, r


def least_s(cfg: dict, pk: dict, valid) -> float:
    """The least time of one call: the encoder's operations on the valid
    tokens at the bf16 peak, then the search's operations or its corpus
    bytes, whichever bounds."""
    return (work.encoder_flops(cfg, valid) / pk["bf16_flops_per_s"]
            + work.search(len(valid), cfg["corpus_rows"], cfg["embedding_dim"]).least_s(pk))


def window(ctx, st: State) -> dict:
    latency = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        i, s, r = call(ctx, st)
        b = time.perf_counter()
        latency.append(b - a)
        st.answers.append((i, s, r))
        if b - t0 >= ctx.seconds:
            break
    per = ctx.mix["queries_per_call"]
    valid = st.queries.valid
    n_calls = len(valid) // per
    pk = work.peaks()
    least = [least_s(ctx.cfg, pk, valid[(i % n_calls) * per:(i % n_calls + 1) * per])
             for i, _s, _r in st.answers]
    return {"latency_s": latency, "window_s": b - t0, "least_s": least,
            "attempted": len(latency) * per, "units": len(latency) * per}


def _replay_ms(graph, fill, reps: int) -> float:
    """Mean device ms of ``graph``'s replays, each after ``fill(rep)`` has
    refilled its static inputs (not timed)."""
    total = 0.0
    for rep in range(reps):
        fill(rep)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def traced(ctx, st: State) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    per, n = mix["queries_per_call"], mix["trace_calls"]
    first = st.next_call

    def segment():
        for _ in range(n):
            call(ctx, st)

    tr = devtrace.traced(segment, dev)
    pool = len(st.queries.valid) // per
    valid = [st.queries.valid[(i % pool) * per:(i % pool + 1) * per]
             for i in range(first, first + n)]
    layers = cfg["num_hidden_layers"]
    w = {
        "scores": work.scores(per, cfg["corpus_rows"], cfg["embedding_dim"], GROUP) * n,
        "attn_fwd": sum((work.attention_fwd(cfg, v, 4) for v in valid), work.Work()) * layers,
    }
    spans = {}
    if dev.type == "cuda":
        from convdr_torch.retrieval.online import capture

        s = st.searcher
        ids = torch.zeros((per, cfg["max_concat_length"]), dtype=torch.int32, device=dev)
        mask = torch.zeros_like(ids)

        def fill(rep):
            i, m = st.queries.call(first + rep, per)
            ids.copy_(torch.from_numpy(i))
            mask.copy_(torch.from_numpy(m))

        fill(0)
        enc, q, _, _ = capture(lambda: s.encode(ids, mask), dev)
        spans["encode"] = _replay_ms(enc, fill, mix["span_reps"])
        srch, _, _, _ = capture(lambda: s.search_embeddings(q), dev)

        def fill_q(rep):
            fill(rep)
            enc.replay()

        spans["search"] = _replay_ms(srch, fill_q, mix["span_reps"])
        del enc, srch, q
    return {"trace": tr, "work": w, "spans_ms": spans}


def check(ctx, st: State, obs: dict) -> dict:
    """Free the program; judge a sample of the window's answers (the longest
    query among them) against the plain reference."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    per, k = mix["queries_per_call"], cfg["top_k"]
    pool = len(st.queries.valid) // per
    window_calls = st.answers
    flat = [(c, j) for c, (_i, _s, _r) in enumerate(window_calls) for j in range(per)]
    rows_of = [(window_calls[c][0] % pool) * per + j for c, j in flat]
    valid = st.queries.valid[rows_of]
    g = traffic.rng(ctx.seed, traffic.SAMPLE)
    size = min(mix["check_requests"], len(flat))
    pick = set(g.choice(len(flat), size=size, replace=False).tolist())
    pick.add(int(np.argmax(valid)))
    pick = sorted(pick)
    prog_s = torch.tensor(np.stack([window_calls[flat[p][0]][1][flat[p][1]] for p in pick]))
    prog_r = torch.tensor(np.stack([window_calls[flat[p][0]][2][flat[p][1]] for p in pick]))
    ids = torch.from_numpy(st.queries.ids[[rows_of[p] for p in pick]]).to(dev)
    mask = torch.from_numpy(st.queries.mask[[rows_of[p] for p in pick]]).to(dev)

    st.searcher = None
    st.answers = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return reference_numbers(cfg, ctx.seed, dev, ids, mask, prog_s.to(dev), prog_r.to(dev), k)


def reference_numbers(cfg, seed, dev, ids, mask, prog_s, prog_r, k) -> dict:
    """The plain reference's judgement of the answers ``prog_*`` [S, k] to
    the queries ``ids`` / ``mask``."""
    w = weights.make_weights(cfg, seed, dev)
    q_ref = embed_rows(w, cfg, ids, mask, "query")
    del w
    ref_s, _ref_i, given = exact_topk_and_scores(q_ref, corpus_makers(cfg, seed, dev), k,
                                                 prog_r.long())
    return checks.search_numbers(prog_s, prog_r, q_ref, ref_s, given, cfg["corpus_rows"])


def corpus_makers(cfg, seed, dev):
    """Callables that each make one block of the corpus again from the seed."""
    return [lambda b=b, lo=lo: (lo, weights.corpus_block(cfg, seed, b, dev))
            for b, (lo, _rows) in enumerate(weights.corpus_blocks(cfg))]


def control(ctx) -> dict:
    """The control's numbers: the plain reference in TF32 (the precision
    below the configuration's f32 with TF32 off) answers as many of the
    pool's queries as a run's check samples, the longest among them, and
    the f32 reference judges those answers as it judges the program's."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    queries = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"],
                                           ctx.seed)
    g = traffic.rng(ctx.seed, traffic.SAMPLE)
    pick = set(g.choice(len(queries.valid), size=mix["check_requests"], replace=False).tolist())
    pick = sorted(pick | {int(np.argmax(queries.valid))})
    ids = torch.from_numpy(queries.ids[pick]).to(dev)
    mask = torch.from_numpy(queries.mask[pick]).to(dev)
    k = cfg["top_k"]
    with checks.tf32():
        w = weights.make_weights(cfg, ctx.seed, dev)
        q = embed_rows(w, cfg, ids, mask, "query")
        del w
        s, r, _ = exact_topk_and_scores(q, corpus_makers(cfg, ctx.seed, dev), k,
                                        torch.zeros((len(pick), k), dtype=torch.long, device=dev))
    return reference_numbers(cfg, ctx.seed, dev, ids, mask, s, r, k)
