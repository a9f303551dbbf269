#!/usr/bin/env python3
"""Smoke run of convdr_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

1. Prints the card's name and power limit, whether ``regex`` imports, and
   ``nvcc -Xptxas -v``'s register / shared-memory / spill lines for each
   kernel (both are built from ``convdr_torch/csrc`` at once).
2. Holds each hand-written kernel against its plain PyTorch version at the
   main path's shapes: flash attention at every corpus length rung
   (32768-token budget; ragged lengths and an all-pad row) in bf16 and f32,
   and the fused score + group-max kernel at Q=512, N=524288, D=768 with f32
   and bf16 storage (scores in f32, top-100 sets).
3. Drives the main path at full RoBERTa-base width (12 layers, hidden 768,
   vocab 50265, seeded random weights): a synthetic 8192-passage token
   cache (lengths 16-512) -> ``gen_passage_embeddings.main`` (bf16) -> two
   more seeded blocks of 524288 rows -> ``run_convdr_inference.main`` over
   512 CAsT-style queries (max_concat_length 256, exact f32 top-100 over
   ~1.06M rows) -> metrics. The kernels' launch counts are zeroed just
   before and read just after; both must be > 0. The run file is then held
   against an exact plain-PyTorch search of the same rows.
4. Prints a ``{"kernels": [...]}`` line (launches, max error, kernel /
   plain / library / bound times in ms, CUDA-event timed after warm-up),
   and last ``{"ok": true, "device": {...}}``.

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
from convdr_torch.drivers import gen_passage_embeddings, run_convdr_inference
from convdr_torch.evaluation.metrics import parse_trec_run
from convdr_torch.models.attention import flash_attention, flash_attention_plain
from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import select_from_groupmax, stable_topk
from convdr_torch.ops.fused_search import (
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.retrieval.blocks import iter_embedding_blocks, write_embedding_block

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
    cuda_build.build(["flash_attention", "scores_groupmax"])  # in parallel
    log(f"nvcc build of both kernels: {time.time() - t0:.1f} s")
    for name in ("flash_attention", "scores_groupmax"):
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
    log("main path (full RoBERTa-base width, seeded weights):")
    try:
        launches, metrics, t_embed, t_infer = main_path(gen)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    result = {"kernels": kernels}
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": smi, "metrics": metrics, "embed_s": t_embed,
                       "inference_s": t_infer, "total_s": time.time() - t_start}, f,
                      indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
