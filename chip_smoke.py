#!/usr/bin/env python3
"""Smoke run of convdr_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

1. Prints the card's name and power limit, whether ``regex`` imports, and
   ``nvcc -Xptxas -v``'s register / shared-memory / spill lines for each
   kernel (the three sources of ``convdr_torch/csrc`` are built at once).
2. Holds each hand-written kernel against its plain PyTorch version at the
   main paths' shapes: the flash-attention forward at every corpus length
   rung (32768-token budget; ragged lengths and an all-pad row) in bf16 and
   f32; its backward (dQ, dK, dV, f32) at the student's B=4 T=256, at T=64,
   at T=200 and at B=40 T=512, each with ragged lengths and an all-pad row;
   and the fused score + group-max kernel at Q=512, N=524288, D=768 with
   f32 and bf16 storage (scores in f32, top-100 sets).
3. Drives the inference path at full RoBERTa-base width (12 layers, hidden
   768, vocab 50265, seeded random weights): a synthetic 8192-passage token
   cache (lengths 16-512) -> ``gen_passage_embeddings.main`` (bf16) -> two
   more seeded blocks of 524288 rows -> ``run_convdr_inference.main`` over
   512 CAsT-style queries (max_concat_length 256, exact f32 top-100 over
   ~1.06M rows) -> metrics. The kernels' launch counts are zeroed just
   before and read just after; both must be > 0. The run file is then held
   against an exact plain-PyTorch search of the same rows.
4. Then (the backward's checks of 2 run here, after the inference path)
   holds one full-width KD + ranking train step with the kernels against
   the same step with the plain attention forward and backward (swapped in
   here), then drives the training path: ``run_convdr_train.main`` (rdot_nll,
   ranking task, 9 negatives, batch 4, 16 steps, checkpoints at 8 and 16)
   on a seeded 64-example CAsT-style file whose documents span the 64-512
   length rungs. The forward and backward launch counts are zeroed before
   and read after (36 and 24 a step); every loss must be finite; the output
   dir must reload through ``load_model_and_params`` and encode a fixed
   batch exactly as the trained in-memory student does.
5. Prints the training ms per step and examples/s, a ``{"kernels": [...]}``
   line (launches, max error, kernel / plain / library / bound times in ms,
   CUDA-event timed after warm-up), and last ``{"ok": true, "device": ...}``.

Any failure raises and exits non-zero. Without a CUDA device it exits 2
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from convdr_torch.core.device import set_exact_matmul
from convdr_torch.data.token_cache import TokenCacheWriter, save_id_maps
from convdr_torch.core.config import TrainConfig
from convdr_torch.core.loading import load_model_and_params
from convdr_torch.drivers import (
    gen_passage_embeddings,
    run_convdr_inference,
    run_convdr_train,
)
from convdr_torch.evaluation.metrics import parse_trec_run
from convdr_torch.models import transformer
from convdr_torch.models.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import select_from_groupmax, stable_topk
from convdr_torch.ops.fused_search import (
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.retrieval.blocks import iter_embedding_blocks, write_embedding_block
from convdr_torch.train.losses import kd_mse_loss, ranking_nll_loss
from convdr_torch.train.trainer import create_train_state, make_train_step

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (batch, T) of gen_passage_embeddings' length rungs at 64 rows x 512 tokens
# (retrieval/embed_corpus.py _BucketBuffer), and the query encoder's shape.
ATTN_SHAPES = [(512, 64), (256, 128), (128, 256), (64, 384), (64, 512)]
HEADS, HEAD_DIM = 12, 64
N_PASSAGES, N_EXTRA, N_TOPICS, N_TURNS = 8192, 524288, 64, 8
SEARCH_Q, SEARCH_N, SEARCH_D, GROUP, TOP_N = 512, 524288, 768, 32, 100
# the training path: batch, negatives, concat / target / doc lengths, steps
TRAIN_B, TRAIN_NEG, TRAIN_T, TARGET_T, DOC_T, TRAIN_STEPS = 4, 9, 256, 64, 512, 16
BWD_SHAPES = [(TRAIN_B, TRAIN_T), (TRAIN_B, TARGET_T), (5, 200), (40, DOC_T)]
KERNELS = ["flash_attention", "scores_groupmax", "flash_attention_bwd"]


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters=10, warmup=3):
    """Mean time of ``fn()`` on the current stream in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gpu_header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    try:
        import regex  # noqa: F401
        log("regex: imports")
    except ImportError:
        log("regex: missing (the BPE pre-tokenizer uses its stdlib re fallback)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


def build_kernels():
    t0 = time.time()
    cuda_build.build(KERNELS)  # one nvcc per source, in parallel
    log(f"nvcc build of {len(KERNELS)} kernel sources: {time.time() - t0:.1f} s")
    for name in KERNELS:
        for line in cuda_build.ptxas_report(name):
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.split('ptxas info    : ')[-1]}")


# ---------------------------------------------------------------------------
# kernel A: flash attention
# ---------------------------------------------------------------------------
def attention_inputs(batch, t, dtype, gen):
    shape = (batch, t, HEADS, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    lens = torch.randint(1, t + 1, (batch,), generator=gen, device="cuda")
    lens[0] = t
    lens[-1] = 0  # an all-pad row
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def attention_bound_ms(q, mask):
    """Bytes (q, k, v, out, mask once each) vs the operations this data
    needs: a query attends to the L valid or the T-L pad keys of its row."""
    b, t, h, d = q.shape
    lens = mask.sum(1).double()
    pairs = float((lens ** 2 + (t - lens) ** 2).sum())
    flops = 4.0 * h * d * pairs
    nbytes = 4 * q.numel() * q.element_size() + mask.numel() * 4
    ops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def check_attention(gen):
    """Kernel vs plain on every rung, bf16 and f32. Tolerance: f32 1e-5
    absolute (same softmax, another summation order); bf16 one bf16 ulp
    (2^-7 relative) -- both round one f32 result to bf16."""
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for batch, t in ATTN_SHAPES + [(4, 256)]:
            q, k, v, mask = attention_inputs(batch, t, dtype, gen)
            out = flash_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, mask)
            diff = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = bool((diff <= 1e-5).all())
            else:
                ok = bool((diff <= 1e-6 + 2.0 ** -7 * ref.float().abs()).all())
            err = diff.max().item()
            finite = bool(torch.isfinite(out.float()).all())
            log(f"  attention {str(dtype)[6:]} B={batch} T={t}: max_abs_err {err:.3e} "
                f"finite {finite} {'ok' if ok and finite else 'FAIL'}")
            if not (ok and finite):
                raise AssertionError(f"flash attention disagrees at B={batch} T={t} {dtype}")
            worst[(dtype, batch, t)] = err
    return worst


def time_attention_shape(batch, t, dtype, gen):
    """Kernel, plain-version and library (masked SDPA) ms, and the bound."""
    q, k, v, mask = attention_inputs(batch, t, dtype, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    bound_ms, bound_by = attention_bound_ms(q, mask)
    return {
        "ms": cuda_ms(lambda: flash_attention(q, k, v, mask)),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def time_attention(gen, worst):
    batch, t = ATTN_SHAPES[-1]
    dtype = torch.bfloat16  # the corpus encoder's dtype
    main = time_attention_shape(batch, t, dtype, gen)
    # the query encoder's shape and dtype (f32 inference, batch 4 x 256)
    query_f32 = {"shape": f"B=4 T=256 H={HEADS} D={HEAD_DIM} f32",
                 "max_abs_err": worst[(torch.float32, 4, 256)],
                 **time_attention_shape(4, 256, torch.float32, gen)}
    per_rung = {}
    for b2, t2 in ATTN_SHAPES:
        q2, k2, v2, m2 = attention_inputs(b2, t2, dtype, gen)
        per_rung[f"B{b2}xT{t2}"] = {
            "ms": cuda_ms(lambda: flash_attention(q2, k2, v2, m2)),
            "bound_ms": attention_bound_ms(q2, m2)[0],
        }
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "convdr_torch/csrc/flash_attention.cu",
        "replaces": "convdr_tpu/models/attention.py:54",
        "launches": 0,
        "max_abs_err": worst[(dtype, batch, t)],
        **main,
        "shape": f"B={batch} T={t} H={HEADS} D={HEAD_DIM} bf16",
        "rungs_bf16": per_rung,
        "query_f32": query_f32,
    }


# ---------------------------------------------------------------------------
# kernel A's backward
# ---------------------------------------------------------------------------
def attention_bwd_bound_ms(q, mask):
    """About 10 * D operations per allowed pair (S and dP recomputed, dQ, dK
    and dV accumulated) on the f32 CUDA cores vs the bytes of q, k, v, o,
    dO read and dQ, dK, dV written once each."""
    b, t, h, d = q.shape
    lens = mask.sum(1).double()
    pairs = float((lens ** 2 + (t - lens) ** 2).sum())
    ops_ms = 10.0 * h * d * pairs / PEAK_FLOPS[torch.float32] * 1e3
    bytes_ms = 8 * q.numel() * 4 / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def bwd_problem(batch, t, gen):
    q, k, v, mask = attention_inputs(batch, t, torch.float32, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    return q, k, v, mask, do, out, lse


def check_attention_bwd(gen):
    """Backward kernel vs flash_attention_bwd_plain at the training shapes.
    Tolerance, per gradient: 1e-5 * max|ref| -- f32 sums of up to T
    products in another order, with P recomputed from the forward's
    log-sum-exp instead of a fresh softmax."""
    worst = {}
    for batch, t in BWD_SHAPES:
        q, k, v, mask, do, out, lse = bwd_problem(batch, t, gen)
        got = flash_attention_bwd(q, k, v, out, do, mask, lse)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(q, k, v, out, do, mask)
        errs, rel = [], []
        for g, r in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"attention backward not finite at B={batch} T={t}")
            errs.append((g - r).abs().max().item())
            rel.append(errs[-1] / r.abs().max().item())
        ok = max(rel) <= 1e-5
        log(f"  attention bwd f32 B={batch} T={t}: max_abs_err dQ/dK/dV "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (max {max(rel):.2e} of max|ref|, "
            f"tol 1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash attention backward disagrees at B={batch} T={t}")
        worst[(batch, t)] = max(errs)
    return worst


def time_attention_bwd(gen, worst):
    """Backward ms at the student's shape: kernel, plain version, and the
    library's (autograd through masked SDPA, f32, backward only)."""
    q, k, v, mask, do, out, lse = bwd_problem(TRAIN_B, TRAIN_T, gen)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
    dot = do.transpose(1, 2)
    bound_ms, bound_by = attention_bwd_bound_ms(q, mask)
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, do, mask, lse))
    # one train step's attention: per layer the student's forward (with lse)
    # and backward, the teacher's target and document forwards (f32)
    per_layer = {"student_fwd": cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, True)),
                 "student_bwd": ms}
    for name, (b2, t2) in (("target_fwd", (TRAIN_B, TARGET_T)),
                           ("docs_fwd", (TRAIN_B * (TRAIN_NEG + 1), DOC_T))):
        q2, k2, v2, m2 = attention_inputs(b2, t2, torch.float32, gen)
        per_layer[name] = cuda_ms(lambda: flash_attention(q2, k2, v2, m2))
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "convdr_torch/csrc/flash_attention_bwd.cu",
        "replaces": "convdr_tpu/models/attention.py:54 (custom VJP: pallas_call "
                    "_flash_attention_bwd_dkv and _flash_attention_bwd_dq)",
        "launches": 0,
        "max_abs_err": worst[(TRAIN_B, TRAIN_T)],
        "ms": ms,
        "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, mask), iters=5),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"B={TRAIN_B} T={TRAIN_T} H={HEADS} D={HEAD_DIM} f32",
        "max_abs_err_by_shape": {f"B{b}xT{t}": e for (b, t), e in worst.items()},
        "train_step_attention_ms": {"per_layer": per_layer,
                                    "x12_layers": 12 * sum(per_layer.values())},
    }


# ---------------------------------------------------------------------------
# kernel B: fused scores + group max
# ---------------------------------------------------------------------------
def top_sets_agree(s_a, s_b, qnorm, pnorm_max, k=TOP_N):
    """Top-k of two score matrices as sets; a row may differ only in
    near-ties at the k-th score, within the f32 tolerance 1e-5*|q|*max|p|."""
    ta = torch.topk(s_a, k, dim=1)
    tb = torch.topk(s_b, k, dim=1)
    exact = 0
    for r in range(s_a.shape[0]):
        a, b = set(ta.indices[r].tolist()), set(tb.indices[r].tolist())
        if a == b:
            exact += 1
            continue
        tol = 1e-5 * qnorm[r].item() * pnorm_max
        kth = tb.values[r, -1].item()
        for idx in a ^ b:
            if abs(s_b[r, idx].item() - kth) > tol:
                raise AssertionError(f"top-{k} sets differ in row {r} beyond near-ties")
    return exact


def check_and_time_search(gen):
    q = torch.randn(SEARCH_Q, SEARCH_D, generator=gen, device="cuda")
    p32 = torch.randn(SEARCH_N, SEARCH_D, generator=gen, device="cuda")
    qnorm = q.norm(dim=1)
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        p = p32.to(dtype)
        s, g = fused_scores_groupmax(q, p, GROUP)
        torch.cuda.synchronize()
        s_ref, g_ref = fused_scores_groupmax_plain(q, p, GROUP)
        pnorm_max = p.float().norm(dim=1).max().item()
        tol = 1e-5 * qnorm[:, None] * pnorm_max
        err = (s - s_ref).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"fused scores disagree ({dtype}): {err.max().item()}")
        if not torch.equal(g, s.view(SEARCH_Q, -1, GROUP).amax(-1)):
            raise AssertionError("group maxima are not the max of each group")
        exact_rows = top_sets_agree(s, s_ref, qnorm, pnorm_max)
        sel_s, sel_i = select_from_groupmax(s.view(SEARCH_Q, -1, GROUP), g, TOP_N, GROUP)
        if not torch.equal(sel_s, stable_topk(s, TOP_N)[0]):
            raise AssertionError("group-max selection != full top-k")
        log(f"  scores+groupmax {str(dtype)[6:]} Q={SEARCH_Q} N={SEARCH_N}: "
            f"max_abs_err {err.max().item():.3e} (tol 1e-5*|q|*max|p|), "
            f"top-{TOP_N} sets equal in {exact_rows}/{SEARCH_Q} rows, near-ties only otherwise")
        ms = cuda_ms(lambda: fused_scores_groupmax(q, p, GROUP))
        plain_ms = cuda_ms(lambda: fused_scores_groupmax_plain(q, p, GROUP), iters=5)
        pf = p.float()
        lib_ms = cuda_ms(
            lambda: torch.matmul(q, pf.T).view(SEARCH_Q, -1, GROUP).amax(-1), iters=5
        )
        nbytes = (q.numel() * 4 + p.numel() * p.element_size()
                  + SEARCH_Q * SEARCH_N * 4 + SEARCH_Q * (SEARCH_N // GROUP) * 4)
        ops_ms = 2.0 * SEARCH_Q * SEARCH_N * SEARCH_D / PEAK_FLOPS[torch.float32] * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"    kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, matmul+amax {lib_ms:.3f} ms, "
            f"bound {max(ops_ms, bytes_ms):.3f} ms")
        result = {
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        }
        if dtype == torch.float32:  # the main path's storage
            entry = {
                "name": "fused_scores_groupmax", "route": "cuda",
                "source": "convdr_torch/csrc/scores_groupmax.cu",
                "replaces": "convdr_tpu/ops/pallas_search.py:118",
                "launches": 0, **result,
                "shape": f"Q={SEARCH_Q} N={SEARCH_N} D={SEARCH_D} G={GROUP} f32",
            }
        else:
            entry["bf16_storage"] = result
        del s, g, s_ref, g_ref, pf, p
    return entry


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def make_inputs(work):
    rng = np.random.default_rng(0)
    processed, raw = os.path.join(work, "processed"), os.path.join(work, "raw")
    os.makedirs(processed)
    os.makedirs(raw)
    lens = rng.integers(16, 513, N_PASSAGES)
    with TokenCacheWriter(os.path.join(processed, "passages"), 512) as w:
        for n in lens:
            ids = rng.integers(3, 50265, n)
            ids[0], ids[-1] = 0, 2  # <s> ... </s>
            w.write(ids)
    total = N_PASSAGES + 2 * N_EXTRA
    offset2pid = np.arange(total, dtype=np.int64) + 1000
    save_id_maps(processed, offset2pid.tolist())
    words = ["what", "about", "the", "history", "of", "jazz", "music", "in",
             "new", "orleans", "and", "its", "influence", "on", "blues", "rock"]
    with open(os.path.join(raw, "eval_topics.jsonl"), "w") as ft, \
            open(os.path.join(raw, "queries.raw.tsv"), "w") as fq, \
            open(os.path.join(raw, "qrels.tsv"), "w") as fr:
        for topic in range(N_TOPICS):
            turns = []
            for turn in range(1, N_TURNS + 1):
                utt = " ".join(rng.choice(words, int(rng.integers(4, 12))))
                turns.append(utt)
                ft.write(json.dumps({"topic_number": topic, "query_number": turn,
                                     "input": list(turns), "target": utt}) + "\n")
                fq.write(f"{topic}_{turn}\t{utt}\n")
                for pid in rng.choice(N_PASSAGES, 3, replace=False) + 1000:
                    fr.write(f"{topic}_{turn}\t0\t{pid}\t{int(rng.integers(1, 3))}\n")
    return processed, raw


def write_extra_blocks(emb_dir, gen):
    for b in (1, 2):
        rows = torch.randn(N_EXTRA, SEARCH_D, generator=gen, device="cuda").cpu().numpy()
        offsets = N_PASSAGES + (b - 1) * N_EXTRA + np.arange(N_EXTRA, dtype=np.int64)
        write_embedding_block(emb_dir, b, rows, offsets)


def reference_check(work, processed, raw, emb_dir, trec):
    """The inference run file against an exact plain-PyTorch search: the same
    query encoder, one f32 matmul over all rows, a stable sort."""
    args = run_convdr_inference.get_arguments(inference_argv(work, processed, raw, emb_dir))
    qids, q_embs, _ = run_convdr_inference.encode_queries(
        args, args.model_path, args.eval_file, torch.float32, torch.device("cuda")
    )
    rows, offs = [], []
    for _b, emb, ids in iter_embedding_blocks(emb_dir):
        rows.append(torch.from_numpy(emb).cuda())
        offs.append(torch.from_numpy(ids.astype(np.int64)).cuda())
    rows, offs = torch.cat(rows), torch.cat(offs)
    q = torch.from_numpy(q_embs).cuda()
    scores = q @ rows.T
    top_s, top_i = stable_topk(scores, TOP_N)
    ref_pids = (offs[top_i] + 1000).cpu().numpy()
    run = parse_trec_run(trec)
    pmax = rows.norm(dim=1).max().item()
    exact = 0
    for r, qid in enumerate(qids):
        got = {pid for pid, _ in run[qid]}
        want = set(ref_pids[r].tolist())
        if got == want:
            exact += 1
            continue
        tol = 1e-5 * q[r].norm().item() * pmax
        kth = top_s[r, -1].item()
        for pid in got ^ want:
            s = scores[r, int(torch.nonzero(offs == pid - 1000)[0])].item()
            if abs(s - kth) > tol:
                raise AssertionError(f"{qid}: run differs from the exact search")
    log(f"  run vs exact plain search: top-{TOP_N} sets equal for {exact}/{len(qids)} "
        "queries, near-ties at the cut otherwise")
    return q_embs.shape


def inference_argv(work, processed, raw, emb_dir):
    return [
        "--model_path", "init", "--model_type", "rdot_nll",
        "--eval_file", os.path.join(raw, "eval_topics.jsonl"),
        "--ann_data_dir", emb_dir, "--processed_data_dir", processed,
        "--raw_data_dir", raw, "--qrels", os.path.join(raw, "qrels.tsv"),
        "--output_trec_file", os.path.join(work, "run.trec"),
        "--output_query_type", "raw", "--query", "no_res",
        "--max_concat_length", "256", "--top_n", str(TOP_N),
    ]


def main_path(gen):
    shutil.rmtree(WORK, ignore_errors=True)
    processed, raw = make_inputs(WORK)
    emb_dir = os.path.join(WORK, "embeddings")
    flash_attention.launches = 0
    fused_scores_groupmax.launches = 0
    t0 = time.time()
    rows = gen_passage_embeddings.main([
        "--data_dir", processed, "--checkpoint", "init", "--model_type", "rdot_nll",
        "--output_dir", emb_dir, "--per_gpu_eval_batch_size", "64",
        "--dtype", "bfloat16", "--num_blocks", "1",
    ])
    t_embed = time.time() - t0
    write_extra_blocks(emb_dir, gen)
    t0 = time.time()
    metrics = run_convdr_inference.main(inference_argv(WORK, processed, raw, emb_dir))
    torch.cuda.synchronize()
    t_infer = time.time() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches}
    log(f"  embedded {rows} passages in {t_embed:.1f} s; inference + search over "
        f"{rows + 2 * N_EXTRA} rows in {t_infer:.1f} s; launches {launches}")
    if rows != N_PASSAGES or min(launches.values()) == 0:
        raise AssertionError(f"main path did not run through both kernels: {launches}")
    for block_id, emb, _ids in iter_embedding_blocks(emb_dir, max_blocks=1):
        if emb.shape != (N_PASSAGES, 768) or not np.isfinite(emb).all():
            raise AssertionError(f"block {block_id}: bad embeddings {emb.shape}")
    for name, value in metrics.items():
        if not (0.0 <= value <= 1.0):
            raise AssertionError(f"metric {name}={value} out of range")
    trec = os.path.join(WORK, "run.trec")
    with open(trec) as f:
        n_lines = sum(1 for _ in f)
    if n_lines != N_TOPICS * N_TURNS * TOP_N:
        raise AssertionError(f"run file has {n_lines} lines")
    reference_check(WORK, processed, raw, emb_dir, trec)
    return launches, metrics, t_embed, t_infer


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
class PlainAttentionFn(torch.autograd.Function):
    """The plain forward and backward, as one autograd function: what the
    kernels' train step is held against."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out = flash_attention_plain(q, k, v, mask)
        ctx.save_for_backward(q, k, v, out, mask)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, mask = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, out, do, mask), None)


def plain_attention(q, k, v, mask):
    if torch.is_grad_enabled() and q.requires_grad:
        return PlainAttentionFn.apply(q, k, v, mask)
    return flash_attention_plain(q, k, v, mask)


def ragged_mask(rows, t, lo, rng):
    lens = rng.integers(lo, t + 1, rows)
    return (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)


def train_step_batch(rng):
    """One seeded full-width batch: concat 256, target 64, 10 docs x 512."""
    k = TRAIN_NEG + 1
    cmask = ragged_mask(TRAIN_B, TRAIN_T, 16, rng)
    tmask = ragged_mask(TRAIN_B, TARGET_T, 4, rng)
    dmask = ragged_mask(TRAIN_B * k, DOC_T, 32, rng).reshape(TRAIN_B, k, DOC_T)
    batch = {
        "concat_ids": rng.integers(3, 50265, (TRAIN_B, TRAIN_T)) * cmask + (1 - cmask),
        "concat_mask": cmask,
        "target_ids": rng.integers(3, 50265, (TRAIN_B, TARGET_T)) * tmask + (1 - tmask),
        "target_mask": tmask,
        "doc_ids": rng.integers(3, 50265, (TRAIN_B, k, DOC_T)) * dmask + (1 - dmask),
        "doc_mask": dmask,
    }
    return {n: torch.from_numpy(a.astype(np.int32)).cuda() for n, a in batch.items()}


def check_train_step():
    """One full-width KD + ranking step: kernels vs plain attention. Loss
    within 1e-5 relative; each parameter's gradient within 1e-4 of its
    largest entry (f32 attention rounding, ~1e-6 a layer, compounding
    through 12 layers forward and back). The key biases' gradient is zero
    in exact arithmetic (softmax shift invariance), rounding noise in both
    versions; it is held to 1e-4 of its layer's key-weight gradient."""
    device = torch.device("cuda")
    _, _, student = load_model_and_params("rdot_nll", "init", device=device, seed=42)
    _, _, teacher = load_model_and_params("rdot_nll", "init", device=device, seed=0)
    teacher.requires_grad_(False)
    init = {n: p.detach().clone() for n, p in student.state_dict().items()}
    batch = train_step_batch(np.random.default_rng(2))
    config = TrainConfig(ranking_task=True, num_negatives=TRAIN_NEG)
    results = {}
    for name, attn in (("kernels", flash_attention), ("plain", plain_attention)):
        transformer.flash_attention = attn
        try:
            student.load_state_dict(init)
            state, tx = create_train_state(student, config, 10)
            _, metrics = make_train_step(student, teacher, tx, config)(state, batch)
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = flash_attention
        results[name] = (float(metrics["loss"]),
                         {n: p.grad.detach().clone() for n, p in student.named_parameters()})
    (loss_k, g_k), (loss_p, g_p) = results["kernels"], results["plain"]
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError(f"train step loss: kernels {loss_k} vs plain {loss_p}")
    worst_rel, worst_name = 0.0, ""
    for n, ref in g_p.items():
        scale_of = n.replace("key.bias", "key.weight") if n.endswith("key.bias") else n
        rel = (g_k[n] - ref).abs().max().item() / g_p[scale_of].abs().max().item()
        if not (np.isfinite(rel) and rel <= 1e-4):
            raise AssertionError(f"train step gradient {n}: {rel:.3e} of its scale")
        if rel > worst_rel:
            worst_rel, worst_name = rel, n
    log(f"  full-width train step, kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f}; "
        f"{len(g_p)} gradients, worst {worst_rel:.2e} of scale ({worst_name}), tol 1e-4 ok")
    del results, g_k, g_p
    phases = time_step_phases(student, teacher, batch, config)
    del student, teacher, init
    torch.cuda.empty_cache()
    return {"loss_kernels": loss_k, "loss_plain": loss_p, "worst_grad_rel": worst_rel,
            "phases_ms": phases}


def time_step_phases(student, teacher, batch, config):
    """CUDA-event ms of the parts of one step on this batch: the teacher's
    document and target encodes, the student's forward + loss + backward,
    and the optimizer update."""
    b, k, length = batch["doc_ids"].shape
    state, tx = create_train_state(student, config, 10)
    params = dict(student.named_parameters())
    with torch.no_grad():
        docs = teacher.body_emb(batch["doc_ids"].reshape(b * k, length),
                                batch["doc_mask"].reshape(b * k, length)).reshape(b, k, -1)
        target = teacher.query_emb(batch["target_ids"], batch["target_mask"])

    def student_fwd_bwd():
        for p in params.values():
            p.grad = None
        embs = student.query_emb(batch["concat_ids"], batch["concat_mask"])
        (kd_mse_loss(embs, target) + ranking_nll_loss(embs, docs)).backward()

    def teacher_docs():
        with torch.no_grad():
            teacher.body_emb(batch["doc_ids"].reshape(b * k, length),
                             batch["doc_mask"].reshape(b * k, length))

    def teacher_target():
        with torch.no_grad():
            teacher.query_emb(batch["target_ids"], batch["target_mask"])

    phases = {"teacher_docs_fwd": cuda_ms(teacher_docs, iters=5, warmup=1),
              "teacher_target_fwd": cuda_ms(teacher_target, iters=5, warmup=1),
              "student_fwd_bwd": cuda_ms(student_fwd_bwd, iters=5, warmup=1)}
    grads = {n: p.grad for n, p in params.items()}
    phases["optimizer"] = cuda_ms(lambda: tx.update(grads, state.opt_state, params),
                                  iters=5, warmup=1)
    log("  one step's parts (ms, CUDA events): " + ", ".join(
        f"{n} {v:.1f}" for n, v in phases.items()) + f"; sum {sum(phases.values()):.1f}")
    return phases


def make_train_file(path):
    """64 CAsT-style examples: conversations of 1-8 turns, a positive and 12
    negatives whose token lengths (the "init" byte vocabulary: about one
    token a character) span the 64-512 rungs."""
    rng = np.random.default_rng(3)
    words = ["what", "about", "the", "history", "of", "jazz", "music", "in", "new",
             "orleans", "and", "its", "influence", "on", "blues", "rock"]

    def text(n_chars):
        out = ""
        while len(out) < n_chars:
            out += " " + str(rng.choice(words))
        return out.strip()

    with open(path, "w") as f:
        for i in range(64):
            turns = [text(int(rng.integers(15, 60))) for _ in range(int(rng.integers(1, 9)))]
            f.write(json.dumps({
                "topic_number": i // 8, "query_number": len(turns), "input": turns,
                "target": turns[-1] + " jazz",
                "doc_pos": text(20) + "[SEP]" + text(int(rng.integers(40, 600))),
                "doc_negs": [text(int(rng.integers(40, 600))) for _ in range(12)],
            }) + "\n")


def step_times(metrics_path, save_steps):
    """Steady-state ms per step from metrics.jsonl's wall times: intervals
    after step 2, leaving out those that hold a checkpoint write."""
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    times = {r["step"]: r["time"] for r in rows}
    gaps = [times[s] - times[s - 1] for s in range(3, len(rows) + 1)
            if (s - 1) % save_steps != 0]
    return rows, 1e3 * float(np.mean(gaps))


def train_path():
    """run_convdr_train.main at full width; counts zeroed just before and
    read just after; then the output dir reloads and encodes a fixed batch
    exactly as the trained in-memory student does."""
    work = os.path.join(WORK, "train")
    os.makedirs(work)
    make_train_file(os.path.join(work, "train.jsonl"))
    out_dir = os.path.join(work, "model")
    trained = {}
    real_run_training = run_convdr_train.run_training

    def keep_models(**kw):
        save = kw["save_fn"]

        def save_and_keep(model, path, tok):
            save(model, path, tok)
            trained[path] = model

        return real_run_training(**{**kw, "save_fn": save_and_keep})

    save_steps = TRAIN_STEPS // 2
    argv = [
        "--output_dir", out_dir, "--train_file", os.path.join(work, "train.jsonl"),
        "--model_type", "rdot_nll", "--model_name_or_path", "init", "--query", "no_res",
        "--ranking_task", "--num_negatives", str(TRAIN_NEG),
        "--per_gpu_train_batch_size", str(TRAIN_B), "--max_concat_length", str(TRAIN_T),
        "--max_doc_length", str(DOC_T), "--learning_rate", "1e-5",
        "--max_steps", str(TRAIN_STEPS), "--save_steps", str(save_steps), "--dtype", "float32",
    ]
    run_convdr_train.run_training = keep_models
    try:
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0
        t0 = time.time()
        outputs = run_convdr_train.main(argv)
        torch.cuda.synchronize()
        t_train = time.time() - t0
        launches = {"flash_attention_fwd": flash_attention.launches,
                    "flash_attention_bwd": flash_attention_bwd.launches}
    finally:
        run_convdr_train.run_training = real_run_training
    log(f"  trained {TRAIN_STEPS} steps in {t_train:.1f} s (model init and "
        f"checkpoints included); launches {launches}")
    want = {"flash_attention_fwd": 36 * TRAIN_STEPS, "flash_attention_bwd": 24 * TRAIN_STEPS}
    if outputs != [out_dir] or launches != want:
        raise AssertionError(f"training path: outputs {outputs}, launches {launches} != {want}")
    rows, ms_step = step_times(os.path.join(out_dir, "metrics.jsonl"), save_steps)
    losses = [r["loss"] for r in rows]
    if len(rows) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training logged {len(rows)} steps, losses {losses}")
    for ckpt in (f"checkpoint-{save_steps}", f"checkpoint-{TRAIN_STEPS}"):
        if not os.path.isdir(os.path.join(out_dir, ckpt)):
            raise AssertionError(f"missing {ckpt}")
    _, tok, reloaded = load_model_and_params("rdot_nll", out_dir, device=torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(3, len(tok), (TRAIN_B, TRAIN_T), generator=gen, device="cuda")
    mask = (torch.arange(TRAIN_T, device="cuda")[None, :]
            < torch.tensor([[256], [100], [17], [3]], device="cuda")).int()
    with torch.no_grad():
        same = torch.equal(reloaded.query_emb(ids, mask), trained[out_dir].query_emb(ids, mask))
    if not same:
        raise AssertionError("the reloaded model encodes differently from the trained one")
    log(f"  training ms/step {ms_step:.1f} (steady state after step 2, checkpoint writes "
        f"left out), {1e3 * TRAIN_B / ms_step:.1f} examples/s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; reloaded model encodes identically")
    return launches, {"ms_per_step": ms_step, "examples_per_s": 1e3 * TRAIN_B / ms_step,
                      "train_s": t_train, "losses": losses}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="", help="also write all results as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    set_exact_matmul()
    t_start = time.time()
    smi = gpu_header()
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log("kernel checks against the plain versions:")
    worst = check_attention(gen)
    kernels = [time_attention(gen, worst), check_and_time_search(gen)]
    torch.cuda.empty_cache()
    log("inference path (full RoBERTa-base width, seeded weights):")
    try:
        launches, metrics, t_embed, t_infer = main_path(gen)
        torch.cuda.empty_cache()
        # the backward's checks come after the inference path, which then
        # runs in the same device-memory state as before training existed
        log("backward kernel check against its plain version:")
        kernels.append(time_attention_bwd(gen, check_attention_bwd(gen)))
        torch.cuda.empty_cache()
        log("training path (full RoBERTa-base width, seeded weights, f32):")
        step_check = check_train_step()
        train_launches, train = train_path()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # each kernel's count on the path of the slice that ported it; the
    # forward runs on both paths
    fwd, search, bwd = kernels
    fwd["launches"] = launches["flash_attention_fwd"]
    fwd["launches_by_path"] = {"inference": launches["flash_attention_fwd"],
                               "train": train_launches["flash_attention_fwd"]}
    search["launches"] = launches["fused_scores_groupmax"]
    bwd["launches"] = train_launches["flash_attention_bwd"]
    attn_ms = bwd["train_step_attention_ms"]["x12_layers"]
    log(f"training: {train['ms_per_step']:.1f} ms/step, {train['examples_per_s']:.1f} "
        f"examples/s (batch {TRAIN_B}, {TRAIN_NEG} negatives, concat {TRAIN_T}, docs <= "
        f"{DOC_T}); attention kernels at the step's shapes {attn_ms:.2f} ms "
        f"({100 * attn_ms / train['ms_per_step']:.1f}% of a step); the step's device parts "
        f"{sum(step_check['phases_ms'].values()):.1f} ms, the rest (input pipeline, "
        f"metrics, host) {train['ms_per_step'] - sum(step_check['phases_ms'].values()):.1f} ms")
    result = {"kernels": kernels}
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": smi, "metrics": metrics, "embed_s": t_embed,
                       "inference_s": t_infer, "train": train, "train_step_check": step_check,
                       "total_s": time.time() - t_start}, f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
