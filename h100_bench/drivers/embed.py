"""The corpus-embedding cells: ``retrieval/embed_corpus.py::
generate_embeddings`` over a token cache, pass after pass, as
``gen_passage_embeddings`` runs it (the mix holds its flags: compute dtype,
GELU, batch, length rungs, block dtype and format).

Set-up writes the passages into a token cache under ``TMPDIR`` with the
port's ``TokenCacheWriter``, builds the model in the mix's compute dtype
and runs one pass over a few rows of every length rung, which builds every
shape the window uses. The window runs whole passes, each into a fresh
directory, and removes the previous pass's blocks. The traced segment runs
``trace_passes`` more passes under the profiler. The check reads back a
seeded sample of the last pass's rows (the longest passage among them) and
compares them with the plain reference, computed in f32 on the weights as
served.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from h100_bench import checks, devtrace, program, traffic, weights, work
from h100_bench.reference.encoder import embed_rows, fp8

EMB_FILE = "passage__emb_p__data_obj_{}.pb"  # ConvDR's block pickles
EMBID_FILE = "passage__embid_p__data_obj_{}.pb"


@dataclass
class State:
    root: str
    cache: object
    apply_fn: object
    lengths: np.ndarray  # valid tokens of each cached passage
    passes: int = 0
    last_dir: str = ""


def model_cfg(ctx) -> dict:
    """The configuration as the mix serves it: its compute dtype and GELU."""
    act = "gelu" if ctx.mix["gelu"] == "erf" else "gelu_pytorch_tanh"
    return dict(ctx.cfg, compute_dtype=ctx.mix["compute_dtype"], hidden_act=act)


def write_cache(path: str, rows, length: int) -> None:
    from convdr_torch.data.token_cache import TokenCacheWriter

    with TokenCacheWriter(path, length) as w:
        for ids in rows:
            w.write(ids)


def buckets(mix: dict):
    from convdr_torch.retrieval.embed_corpus import default_length_buckets

    if mix["length_buckets"] != "auto":
        raise ValueError(f"length_buckets {mix['length_buckets']!r} is not run here")
    return default_length_buckets(mix["max_seq_length"])


def run_pass(ctx, st: State, cache=None, out: str = None) -> int:
    """One ``generate_embeddings`` pass into a fresh directory; returns the
    rows written."""
    from convdr_torch.retrieval.embed_corpus import generate_embeddings

    mix = ctx.mix
    if out is None:
        out = os.path.join(st.root, f"pass{st.passes}")
        st.passes += 1
    rows = generate_embeddings(
        st.apply_fn, st.cache if cache is None else cache, out, device=ctx.device, batch_size=mix["batch_size"],
        num_blocks=mix["num_blocks"], length_buckets=buckets(mix),
        block_format=mix["block_format"], storage_dtype=mix["storage_dtype"])
    return rows


def setup(ctx) -> State:
    from convdr_torch.core.loading import make_apply_fn
    from convdr_torch.data.token_cache import TokenCache

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    root = tempfile.mkdtemp(prefix="h100_bench_embed_")
    rows = traffic.passages(mix, cfg["layout"], ctx.seed)
    write_cache(os.path.join(root, "passages"), rows, mix["max_seq_length"])
    # one passage a length rung: every batch shape of the window, once
    warm = [np.resize(rows[0], min(r, mix["max_seq_length"])) for r in buckets(mix)]
    write_cache(os.path.join(root, "warm"), warm, mix["max_seq_length"])
    model = program.build_model(model_cfg(ctx), weights.make_weights(cfg, ctx.seed, dev), dev)
    st = State(root, TokenCache(os.path.join(root, "passages")), make_apply_fn(model),
               np.array([len(r) for r in rows]))
    run_pass(ctx, st, TokenCache(os.path.join(root, "warm")), os.path.join(root, "warm_out"))
    shutil.rmtree(os.path.join(root, "warm_out"))
    return st


def one_pass(ctx, st: State) -> None:
    """A window's pass; the previous pass's blocks are removed after it."""
    previous = st.last_dir
    st.last_dir = os.path.join(st.root, f"pass{st.passes}")
    rows = run_pass(ctx, st)
    if rows != len(st.lengths):
        raise RuntimeError(f"a pass wrote {rows} rows for {len(st.lengths)} passages")
    if previous:
        shutil.rmtree(previous)


def window(ctx, st: State) -> dict:
    t0 = time.perf_counter()
    passes = 0
    while True:
        one_pass(ctx, st)
        passes += 1
        b = time.perf_counter()
        if b - t0 >= ctx.seconds:
            break
    pk = work.peaks()
    least = work.encoder_flops(ctx.cfg, st.lengths) / pk["bf16_flops_per_s"]
    n = len(st.lengths) * passes
    return {"window_s": b - t0, "least_s": [least] * passes, "attempted": n, "units": n}


def traced(ctx, st: State) -> dict:
    n = ctx.mix["trace_passes"]

    def segment():
        for _ in range(n):
            one_pass(ctx, st)

    tr = devtrace.traced(segment, ctx.device)
    elem = torch.empty((), dtype=program.DTYPES[ctx.mix["compute_dtype"]]).element_size()
    fwd = work.attention_fwd(ctx.cfg, st.lengths, elem) * (ctx.cfg["num_hidden_layers"] * n)
    return {"trace": tr, "work": {"attn_fwd": fwd}}


def read_block(out: str):
    """(rows [N, D] f32, their token-cache offsets [N]) of a pass's block 0."""
    with open(os.path.join(out, EMB_FILE.format(0)), "rb") as f:
        emb = np.asarray(pickle.load(f), np.float32)
    with open(os.path.join(out, EMBID_FILE.format(0)), "rb") as f:
        ids = np.asarray(pickle.load(f), np.int64)
    return emb, ids


def sample(ctx, lengths: np.ndarray) -> np.ndarray:
    """Cache offsets to compare: a seeded sample and the longest passage."""
    g = traffic.rng(ctx.seed, traffic.SAMPLE)
    pick = g.choice(len(lengths), size=min(ctx.mix["check_requests"], len(lengths)),
                    replace=False)
    return np.unique(np.append(pick, np.argmax(lengths)))


def check(ctx, st: State, obs: dict) -> dict:
    emb, ids = read_block(st.last_dir)
    shutil.rmtree(st.root)
    st.cache = st.apply_fn = None
    n = len(st.lengths)
    counts = np.bincount(ids[(ids >= 0) & (ids < n)], minlength=n)
    bad = int(np.sum(counts != 1)) + int(np.sum((ids < 0) | (ids >= n)))
    if emb.shape[0] != ids.shape[0]:
        bad += abs(emb.shape[0] - ids.shape[0])
    offsets = sample(ctx, st.lengths)
    row_of = {int(o): r for r, o in enumerate(ids)}
    found = [o for o in offsets if int(o) in row_of]
    prog = torch.from_numpy(emb[[row_of[int(o)] for o in found]]).to(ctx.device)
    return dict(reference_gaps(ctx, found, prog), bad_rows=float(bad))


def reference_gaps(ctx, offsets, prog: torch.Tensor, rnd=None) -> dict:
    """``emb_gap``: the widest relative distance of the rows ``prog`` from
    the plain reference's embeddings of the passages at ``offsets``, made
    again from the seed."""
    cfg, mix, dev = model_cfg(ctx), ctx.mix, ctx.device
    rows = traffic.passages(mix, cfg["layout"], ctx.seed)
    ids = np.zeros((len(offsets), mix["max_seq_length"]), np.int32)
    mask = np.zeros_like(ids)
    for i, o in enumerate(offsets):
        ids[i, :len(rows[o])] = rows[o]
        mask[i, :len(rows[o])] = 1
    dtype = program.DTYPES[mix["compute_dtype"]]
    w = weights.as_served(cfg, weights.make_weights(cfg, ctx.seed, dev), dtype)
    ref = embed_rows(w, cfg, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                     "body", rows=16)
    if rnd is not None:  # the control
        prog = embed_rows(w, cfg, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                          "body", rows=16, rnd=rnd)
    gap = torch.linalg.vector_norm(prog.float() - ref, dim=1) / torch.linalg.vector_norm(ref, dim=1)
    return {"emb_gap": float(gap.max()) if len(offsets) else float("nan")}


def control(ctx) -> dict:
    """The control's numbers: the plain reference with fp8 (e4m3) operands,
    the precision below the mix's bf16, on the passages a check samples."""
    lengths = np.array([len(r) for r in traffic.passages(ctx.mix, ctx.cfg["layout"], ctx.seed)])
    offsets = sample(ctx, lengths)
    return dict(reference_gaps(ctx, offsets, None, rnd=fp8), bad_rows=0.0)
