#!/usr/bin/env python3
"""Smoke run of convdr_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

1. Prints the card's name and power limit, whether ``regex`` imports,
   ``nvcc -Xptxas -v``'s register / shared-memory / spill lines for each
   kernel (the five sources of ``convdr_torch/csrc`` are built at once) and
   the launch configurations (threads, dynamic shared memory, query rows a
   block, resident blocks an SM; keys a tile) of the score kernel and of
   the flash-attention forward and backward at every shape timed or
   checked below, and of pass B per passage dtype and group (slots a work
   item, resident blocks an SM). Every entry of the ``kernels`` line
   carries its source's registers and spills by kernel and its launch
   configuration.
2. Holds each hand-written kernel against its plain PyTorch version at the
   main paths' shapes: the flash-attention forward at every corpus length
   rung (32768-token budget; ragged lengths and an all-pad row) and at the
   train step's f32 shapes (B=4 T=256 and T=64, B=40 T=512), in bf16 and
   f32, timed beside masked SDPA and its bound at every rung and at the
   f32 B=4 T=256 and B=40 T=512 shapes (device-only times too at B=4 T=256
   f32 and B=512 T=64 bf16); its backward (dQ, dK, dV, f32, one launch) at
   the student's B=4 T=256, at T=64, at T=200 and at B=40 T=512, each under
   right-, left-, middle-padded and random masks with an all-pad row, two
   calls bit-identical, timed at B=4 T=256 host-paced and on the device
   beside autograd through masked SDPA; and the fused score + group-max
   kernel at Q=512, N=524288, D=768 with
   f32, bf16 and int8 storage (scores in f32, top-100 sets; int8, on the
   tensor cores, equal to its integer-exact plain version), timed at Q=512
   and 64 beside one library call of the same function (``torch.matmul``,
   TF32 off, + ``amax``; int8: ``torch._int_mm`` + ``.float()`` + ``amax``)
   and the library's product alone; the int8 bound is taken at the int8
   tensor-core peak.
2b. The rest of the exact-search layer at the same width (one 524288-row
   block, D=768): the streaming search's two passes and
   ``streaming_flat_ip_topk`` with f32, bf16 and int8 passages, G=128 and
   32, Q=512 and 64 (pass A's maxima and pass B's candidates equal to the
   score kernel's, the streaming top-100 equal to ``flat_ip_topk``'s, and
   near-tie sets against the plain versions; the peak device memory of the
   streaming search and of ``flat_ip_topk``), and the group gather kernel
   (equal to ``torch.gather`` at Q=512, K=101, G=32; ``flat_ip_topk(
   gather="dma")`` equal to ``gather="auto"``: both take the kernel). Pass
   B's work list (the counting sort on the card) is held to its plain
   version; pass B is timed host-paced through the public entry (whose
   range check waits for the kernel) and on the device through the entry
   the streaming search calls (work list + kernel, no host sync), at Q=512
   and 64 with f32, bf16 and int8 passages, each beside its bytes bound;
   the gather host-paced, on the device and by its host time a call. The
   streaming kernels' launch counts are zeroed just before and read just
   after the entry point's calls; the gather's come from the main path (3).
3. Drives the inference path at full RoBERTa-base width (12 layers, hidden
   768, vocab 50265, seeded random weights): a synthetic 8192-passage token
   cache (lengths 16-512) -> ``gen_passage_embeddings.main`` (bf16) -> two
   more seeded blocks of 524288 rows -> ``run_convdr_inference.main`` over
   512 CAsT-style queries (max_concat_length 256, exact f32 top-100 over
   ~1.06M rows) -> metrics. The kernels' launch counts (attention, score
   kernel, candidate gather) are zeroed just before and read just after;
   each must be > 0. The run file is then held against an exact
   plain-PyTorch search of the same rows.
3b. The int8 (SQ8) user path through the same drivers:
   ``gen_passage_embeddings.main --storage_dtype int8`` (int8 blocks + the
   scales sidecar; the two extra blocks quantized with it), then
   ``run_convdr_inference.main --storage_dtype int8``, whose run must equal
   an integer-exact plain search of the same quantized rows index for
   index, and ``--storage_dtype int8 --rescore_factor 2`` over the f32
   blocks (device SQ8, host refine), whose run must equal, index for index,
   one built without the searcher: scales self-fitted on block 0, each
   block quantized on the host, its integer-exact top 200 by a plain
   matmul, those rows refined in f32, the blocks merged in order. The
   score kernel's count is zeroed before and read after.
4. Then (the backward's checks of 2 run here, after the inference path)
   holds one full-width KD + ranking train step with the kernels against
   the same step with the plain attention forward and backward (swapped in
   here), then drives the training path: ``run_convdr_train.main`` (rdot_nll,
   ranking task, 9 negatives, batch 4, 16 steps, checkpoints at 8 and 16)
   on a seeded 64-example CAsT-style file whose documents span the 64-512
   length rungs. The forward and backward launch counts are zeroed before
   and read after (36 and 12 a step); the forward's launches are also
   counted by (dtype, T) on this path and the inference path, through a
   shim around ``attention.flash_attention_fwd`` that must agree with the
   kernel's own count; every loss must be finite; the output
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
import collections
import ctypes
import json
import os
import re
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
from convdr_torch.models import attention, transformer
from convdr_torch.models.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_config,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_config,
    flash_attention_plain,
)
from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import (
    flat_ip_topk,
    grouped_topk_last_axis,
    select_from_groupmax,
    stable_topk,
)
from convdr_torch.ops.fused_search import (
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.ops.gather_groups import dma_gather_groups, dma_gather_groups_plain
from convdr_torch.ops.quant import Int8Quantizer, quantize_passages_dev, rescore_candidates
from convdr_torch.ops.streaming_search import (
    candidate_work_list,
    candidate_work_list_plain,
    extract_candidate_scores,
    extract_candidate_scores_plain,
    extract_candidate_scores_unchecked,
    streaming_flat_ip_topk,
    streaming_groupmax,
    streaming_groupmax_plain,
)
from convdr_torch.retrieval.blocks import iter_embedding_blocks, write_embedding_block
from convdr_torch.train.losses import kd_mse_loss, ranking_nll_loss
from convdr_torch.train.trainer import create_train_state, make_train_step

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

# (batch, T) of gen_passage_embeddings' length rungs at 64 rows x 512 tokens
# (retrieval/embed_corpus.py _BucketBuffer), and the query encoder's shape.
ATTN_SHAPES = [(512, 64), (256, 128), (128, 256), (64, 384), (64, 512)]
HEADS, HEAD_DIM = 12, 64
N_PASSAGES, N_EXTRA, N_TOPICS, N_TURNS = 8192, 524288, 64, 8
SEARCH_Q, SEARCH_N, SEARCH_D, GROUP, TOP_N = 512, 524288, 768, 32, 100
# the streaming search: a small query batch beside 512, its groups; the
# candidate groups of a masked block (k + 1) for timing passes B and the gather
SMALL_Q, STREAM_GROUPS, CAND_GROUPS = 64, (128, 32), TOP_N + 1
STORAGE = (torch.float32, torch.bfloat16, torch.int8)
# the training path: batch, negatives, concat / target / doc lengths, steps
TRAIN_B, TRAIN_NEG, TRAIN_T, TARGET_T, DOC_T, TRAIN_STEPS = 4, 9, 256, 64, 512, 16
BWD_SHAPES = [(TRAIN_B, TRAIN_T), (TRAIN_B, TARGET_T), (5, 200), (40, DOC_T)]
MASK_KINDS = ("right", "left", "middle", "random")
# the f32 forward's shapes in a train step: the student's concat, the
# teacher's targets and documents (batch x (negatives + 1) rows of 512)
F32_SHAPES = [(TRAIN_B, TRAIN_T), (TRAIN_B, TARGET_T), (TRAIN_B * (TRAIN_NEG + 1), DOC_T)]
KERNELS = ["flash_attention", "scores_groupmax", "flash_attention_bwd",
           "streaming_search", "gather_groups"]


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


def device_ms(fn, iters=20):
    """Mean device time of ``fn()`` in ms: the calls are queued behind a
    ~50 ms spin kernel, so the host's work for each call overlaps the spin
    and the events time the kernels back to back. ``fn`` must not sync."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=200):
    """Host time of one call of ``fn`` in us, the calls queued behind a
    ~50 ms spin kernel so that none waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def peak_mib(fn):
    """Device memory (MiB) one call of ``fn`` holds at its peak, above what
    was allocated before it (the caching allocator's count)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


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
                log(f"  {name}: {line.split('ptxas info    : ')[-1].strip()}")
    return {"scores_groupmax": score_kernel_configs(), "flash_attention_fwd": attention_configs(),
            "flash_attention_bwd": attention_bwd_configs(),
            "extract_candidate_scores": pass_b_configs()}


_MANGLED_TYPES = {"f": "float", "a": "int8", "i": "int", "x": "int64", "j": "uint32",
                  "b": "bool", "13__nv_bfloat16": "bf16"}


def kernel_entry_name(mangled):
    """``name<args>`` of a mangled kernel in an anonymous namespace, e.g.
    ``extract_candidates_kernel<float,128>``; the mangled name if it does
    not parse."""
    i, parts = 3, []
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not parts:
        return mangled
    args, rest = [], mangled[i + 1:] if mangled[i:i + 1] == "I" else ""
    while rest and rest[0] != "E":
        m = re.match(r"L[a-z](\d+)E|13__nv_bfloat16|[a-z]", rest)
        if m is None:
            return mangled
        args.append(m.group(1) or _MANGLED_TYPES.get(m.group(0), m.group(0)))
        rest = rest[m.end():]
    return f"{parts[-1]}<{','.join(args)}>" if args else parts[-1]


def ptxas_summary(name):
    """Registers and spill bytes of every kernel in ``csrc/<name>.cu``, by
    entry, from the build's ``nvcc -Xptxas -v`` report."""
    out, entry = {}, None
    for line in cuda_build.ptxas_report(name):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = kernel_entry_name(m.group(1))
            out[entry] = {}
        elif entry and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[entry].update(spill_stores=int(st), spill_loads=int(ld))
        elif entry and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def pass_b_configs():
    """Pass B's launch configuration per passage dtype at the two groups
    the search block runs (threads, dynamic shared memory, slots a work
    item, resident blocks an SM, SMs), as
    ``convdr_extract_candidates_config`` reports it."""
    fn = cuda_build.bind("streaming_search", "convdr_extract_candidates_config",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    configs = {}
    for code, dtype in enumerate(STORAGE):
        for group in STREAM_GROUPS:
            out = (ctypes.c_int * 5)()
            rc = fn(code, group, ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(f"convdr_extract_candidates_config: CUDA error {rc}")
            configs[f"{dtype_name(dtype)}_G{group}"] = dict(
                zip(("threads", "smem_bytes", "item_slots", "blocks_per_sm", "sms"), out))
    log("  extract_candidate_scores launch configs: " + "; ".join(
        f"{k} {v['threads']} threads, {v['smem_bytes']} B smem, {v['item_slots']} slots an "
        f"item, {v['blocks_per_sm']} blocks/SM x {v['sms']} SMs" for k, v in configs.items()))
    return configs


def gather_config(scores, gsel, group):
    """The group gather's launch for these operands (path, threads,
    blocks, values a thread), as ``convdr_gather_groups_config`` reports it."""
    fn = cuda_build.bind("gather_groups", "convdr_gather_groups_config",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = (ctypes.c_int * 4)()
    # the kernel's output is a fresh (16-byte aligned) allocation
    rc = fn(scores.data_ptr(), 0, scores.shape[0], scores.shape[1], gsel.shape[1], group,
            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"convdr_gather_groups_config: CUDA error {rc}")
    return {"path": "16-byte vectors" if out[0] else "scalar", "threads": out[1],
            "blocks": out[2], "values_a_thread": out[3]}


def attention_configs():
    """The forward kernel's launch configuration at every timed shape, as
    ``convdr_flash_attention_fwd_config`` reports it."""
    configs = {}
    for dtype, shapes in ((torch.bfloat16, ATTN_SHAPES), (torch.float32, F32_SHAPES)):
        for batch, t in shapes:
            configs[f"{dtype_name(dtype)}_B{batch}xT{t}"] = flash_attention_fwd_config(
                batch, t, HEADS, HEAD_DIM, dtype)
    log("  flash_attention_fwd launch configs: " + "; ".join(
        f"{k} {v['threads']} threads, {v['smem_bytes']} B smem, {v['block_queries']} queries x "
        f"{v['tile_keys']} keys, {v['blocks_per_sm']} blocks/SM" for k, v in configs.items()))
    return configs


def attention_bwd_configs():
    """The backward kernel's launch configuration at every checked shape,
    as ``convdr_flash_attention_bwd_config`` reports it."""
    configs = {f"f32_B{batch}xT{t}": flash_attention_bwd_config(batch, t, HEADS, HEAD_DIM)
               for batch, t in BWD_SHAPES}
    log("  flash_attention_bwd launch configs: " + "; ".join(
        f"{k} {v['threads']} threads, {v['smem_bytes']} B smem, {v['block_rows']} rows a block x "
        f"{v['tile_rows']}-row tiles, {v['blocks_per_sm']} blocks/SM" for k, v in configs.items()))
    return configs


def score_kernel_configs():
    """The score kernel's launch configuration per passage dtype and query
    count (threads, dynamic shared memory, query rows a block, resident
    blocks an SM), as ``convdr_scores_groupmax_config`` reports it."""
    fn = cuda_build.load("scores_groupmax").convdr_scores_groupmax_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    configs = {}
    for code, dtype in enumerate(STORAGE):
        for qn in (SEARCH_Q, SMALL_Q):
            out = (ctypes.c_int * 4)()
            rc = fn(code, qn, ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(f"convdr_scores_groupmax_config: CUDA error {rc}")
            configs[f"{dtype_name(dtype)}_Q{qn}"] = dict(
                zip(("threads", "smem_bytes", "block_queries", "blocks_per_sm"), out))
    log("  scores_groupmax launch configs: " + "; ".join(
        f"{k} {v['threads']} threads, {v['smem_bytes']} B smem, {v['block_queries']} queries a "
        f"block, {v['blocks_per_sm']} blocks/SM" for k, v in configs.items()))
    return configs


# ---------------------------------------------------------------------------
# kernel A: flash attention
# ---------------------------------------------------------------------------
def attention_inputs(batch, t, dtype, gen, mask_kind="right"):
    """Seeded q/k/v and a [B, T] 0/1 mask: row 0 all valid, the last row all
    pad, the others a random number of valid tokens first ("right"), last
    ("left") or in a run between pads ("middle"); or ("random") each token
    valid with probability 1/2 and the last row all pad."""
    shape = (batch, t, HEADS, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    lens = torch.randint(1, t + 1, (batch,), generator=gen, device="cuda")
    lens[0] = t
    lens[-1] = 0  # an all-pad row
    pos = torch.arange(t, device="cuda")[None, :]
    if mask_kind == "right":
        valid = pos < lens[:, None]
    elif mask_kind == "left":
        valid = pos >= t - lens[:, None]
    elif mask_kind == "middle":
        start = torch.randint(0, t, (batch,), generator=gen, device="cuda") % (t - lens + 1)
        valid = (pos >= start[:, None]) & (pos < (start + lens)[:, None])
    else:
        valid = torch.rand((batch, t), generator=gen, device="cuda") < 0.5
        valid[-1] = False
    return q, k, v, valid.to(torch.int32)


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
    """Kernel vs plain on every rung and the train step's f32 shapes, bf16
    and f32. Tolerance: f32 1e-5 absolute (same softmax, another summation
    order); bf16 one bf16 ulp (2^-7 relative) -- both round one f32 result
    to bf16."""
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for batch, t in ATTN_SHAPES + F32_SHAPES:
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


def time_attention_shape(batch, t, dtype, gen, plain=True, device=False):
    """Kernel and library (masked SDPA) ms, the plain version's (``plain``),
    the bound, the launch configuration and, with ``device``, the kernel's
    and SDPA's device-only times (queued behind a spin kernel)."""
    q, k, v, mask = attention_inputs(batch, t, dtype, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    bound_ms, bound_by = attention_bound_ms(q, mask)
    kernel = lambda: flash_attention(q, k, v, mask)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)  # noqa: E731
    result = {"ms": cuda_ms(kernel), "library_ms": cuda_ms(library),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "config": flash_attention_fwd_config(batch, t, HEADS, HEAD_DIM, dtype)}
    if plain:
        result["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5)
    if device:
        result["device_ms"] = device_ms(kernel)
        result["library_device_ms"] = device_ms(library)
    return result


def time_attention(gen, worst):
    batch, t = ATTN_SHAPES[-1]
    dtype = torch.bfloat16  # the corpus encoder's dtype
    main = time_attention_shape(batch, t, dtype, gen)
    # the query encoder's and student's shape (f32, batch 4 x 256)
    query_f32 = {"shape": f"B=4 T=256 H={HEADS} D={HEAD_DIM} f32",
                 "max_abs_err": worst[(torch.float32, 4, 256)],
                 **time_attention_shape(4, 256, torch.float32, gen, device=True)}
    # the teacher's documents in a train step (f32, 40 x 512)
    docs_b, docs_t = F32_SHAPES[-1]
    docs_f32 = {"shape": f"B={docs_b} T={docs_t} H={HEADS} D={HEAD_DIM} f32",
                "max_abs_err": worst[(torch.float32, docs_b, docs_t)],
                **time_attention_shape(docs_b, docs_t, torch.float32, gen)}
    per_rung = {}
    for b2, t2 in ATTN_SHAPES:
        per_rung[f"B{b2}xT{t2}"] = {
            "max_abs_err": worst[(dtype, b2, t2)],
            **time_attention_shape(b2, t2, dtype, gen, plain=False, device=b2 == 512)}
    log("  flash_attention_fwd ms (kernel / SDPA / bound): " + "; ".join(
        f"{name} {r['ms']:.4f} / {r['library_ms']:.4f} / {r['bound_ms']:.4f}"
        + (f" (device {r['device_ms']:.4f} / {r['library_device_ms']:.4f})"
           if "device_ms" in r else "")
        for name, r in [*((f"bf16 {k}", v) for k, v in per_rung.items()),
                        ("f32 B4xT256", query_f32), (f"f32 B{docs_b}xT{docs_t}", docs_f32)]))
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
        "teacher_docs_f32": docs_f32,
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


def bwd_problem(batch, t, gen, mask_kind="right"):
    q, k, v, mask = attention_inputs(batch, t, torch.float32, gen, mask_kind)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    return q, k, v, mask, do, out, lse


def check_attention_bwd(gen):
    """Backward kernel vs flash_attention_bwd_plain at the training shapes,
    under every mask kind (the tile plan skips on segment ranges), then two
    calls on the same inputs, which must be bit-identical (no atomics).
    Tolerance, per gradient: 1e-5 * max|ref| -- f32 sums of up to T
    products in another order, with P recomputed from the forward's
    log-sum-exp instead of a fresh softmax."""
    worst = {}
    for batch, t in BWD_SHAPES:
        for kind in MASK_KINDS:
            q, k, v, mask, do, out, lse = bwd_problem(batch, t, gen, kind)
            got = flash_attention_bwd(q, k, v, out, do, mask, lse)
            torch.cuda.synchronize()
            want = flash_attention_bwd_plain(q, k, v, out, do, mask)
            errs, rel = [], []
            for g, r in zip(got, want):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"attention backward not finite at B={batch} T={t} {kind}")
                errs.append((g - r).abs().max().item())
                rel.append(errs[-1] / r.abs().max().item())
            ok = max(rel) <= 1e-5
            log(f"  attention bwd f32 B={batch} T={t} {kind}: max_abs_err dQ/dK/dV "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (max {max(rel):.2e} of max|ref|, "
                f"tol 1e-5) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash attention backward disagrees at B={batch} T={t} {kind}")
            worst[(batch, t, kind)] = max(errs)
    q, k, v, mask, do, out, lse = bwd_problem(TRAIN_B, TRAIN_T, gen, "random")
    first = flash_attention_bwd(q, k, v, out, do, mask, lse)
    second = flash_attention_bwd(q, k, v, out, do, mask, lse)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two backward calls on the same inputs differ")
    log(f"  attention bwd f32 B={TRAIN_B} T={TRAIN_T}: two calls bit-identical")
    return worst


def time_attention_bwd(gen, worst):
    """Backward ms at the student's shape (right-padded mask): kernel, plain
    version, and the library's (autograd through masked SDPA, f32,
    backward only), the kernel and the library both host-paced and on the
    device alone (queued behind a spin kernel)."""
    q, k, v, mask, do, out, lse = bwd_problem(TRAIN_B, TRAIN_T, gen)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)
    dot = do.transpose(1, 2)
    bound_ms, bound_by = attention_bwd_bound_ms(q, mask)
    kernel = lambda: flash_attention_bwd(q, k, v, out, do, mask, lse)  # noqa: E731
    library = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    ms = cuda_ms(kernel, iters=50)
    timing = {"ms": ms, "device_ms": device_ms(kernel, iters=50),
              "library_ms": cuda_ms(library, iters=50),
              "library_device_ms": device_ms(library, iters=50)}
    # one train step's attention: per layer the student's forward (with lse)
    # and backward, the teacher's target and document forwards (f32)
    per_layer = {"student_fwd": cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, True)),
                 "student_bwd": ms}
    for name, (b2, t2) in (("target_fwd", (TRAIN_B, TARGET_T)),
                           ("docs_fwd", (TRAIN_B * (TRAIN_NEG + 1), DOC_T))):
        q2, k2, v2, m2 = attention_inputs(b2, t2, torch.float32, gen)
        per_layer[name] = cuda_ms(lambda: flash_attention(q2, k2, v2, m2))
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, mask), iters=5)
    log(f"  flash_attention_bwd B={TRAIN_B} T={TRAIN_T} f32 ms: kernel {ms:.4f} host-paced, "
        f"{timing['device_ms']:.4f} on the device; SDPA backward {timing['library_ms']:.4f} / "
        f"{timing['library_device_ms']:.4f}; plain {plain_ms:.4f}; bound {bound_ms:.4f} "
        f"({bound_by})")
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "convdr_torch/csrc/flash_attention_bwd.cu",
        "replaces": "convdr_tpu/models/attention.py:54 (custom VJP: pallas_call "
                    "_flash_attention_bwd_dkv and _flash_attention_bwd_dq)",
        "launches": 0,
        "max_abs_err": worst[(TRAIN_B, TRAIN_T, "right")],
        **timing,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"B={TRAIN_B} T={TRAIN_T} H={HEADS} D={HEAD_DIM} f32",
        "config": flash_attention_bwd_config(TRAIN_B, TRAIN_T, HEADS, HEAD_DIM),
        "max_abs_err_by_shape": {f"B{b}xT{t}_{kind}": e for (b, t, kind), e in worst.items()},
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


def kernel_bound(flops, nbytes, dtype=torch.float32):
    """The least time (ms) for ``flops`` operations at the peak of
    ``dtype``'s units (f32: the CUDA cores; int8: the tensor cores) and
    ``nbytes`` moved, and which of the two bounds it."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def search_operands(q32, p32, dtype):
    """The queries and passages of one storage dtype. int8 passages are the
    device SQ8 of the f32 rows with scales fitted on their first 65536, and
    come with the int-valued queries of the same quantizer."""
    if dtype != torch.int8:
        return q32, p32.to(dtype)
    quant = Int8Quantizer.fit(p32[:65536].cpu().numpy())
    p = quantize_passages_dev(p32, torch.from_numpy(quant.scales).cuda())
    q = torch.from_numpy(quant.quantize_queries(q32.cpu().numpy())[0]).cuda()
    return q, p


def dtype_name(dtype):
    return str(dtype)[6:]


def check_and_time_search(q32, p32):
    """Kernel 2 vs plain at Q=512 N=524288 D=768 G=32. f32 and bf16: scores
    within 1e-5*|q|*max|p|, top-100 sets equal up to near-ties; int8: equal
    (integer-exact in both)."""
    entry = None
    for dtype in STORAGE:
        q, p = search_operands(q32, p32, dtype)
        qnorm = q.norm(dim=1)
        s, g = fused_scores_groupmax(q, p, GROUP)
        torch.cuda.synchronize()
        s_ref, g_ref = fused_scores_groupmax_plain(q, p, GROUP)
        pnorm_max = p.float().norm(dim=1).max().item()
        tol = 1e-5 * qnorm[:, None] * pnorm_max
        err = (s - s_ref).abs()
        if dtype == torch.int8 and not (torch.equal(s, s_ref) and torch.equal(g, g_ref)):
            raise AssertionError(f"int8 scores differ from the integer-exact plain version: "
                                 f"{err.max().item()}")
        if not bool((err <= tol).all()):
            raise AssertionError(f"fused scores disagree ({dtype}): {err.max().item()}")
        if not torch.equal(g, s.view(SEARCH_Q, -1, GROUP).amax(-1)):
            raise AssertionError("group maxima are not the max of each group")
        exact_rows = top_sets_agree(s, s_ref, qnorm, pnorm_max)
        sel_s, sel_i = select_from_groupmax(s.view(SEARCH_Q, -1, GROUP), g, TOP_N, GROUP)
        if not torch.equal(sel_s, stable_topk(s, TOP_N)[0]):
            raise AssertionError("group-max selection != full top-k")
        log(f"  scores+groupmax {dtype_name(dtype)} Q={SEARCH_Q} N={SEARCH_N}: "
            f"max_abs_err {err.max().item():.3e} (tol 1e-5*|q|*max|p|"
            f"{'; int8: equal' if dtype == torch.int8 else ''}), "
            f"top-{TOP_N} sets equal in {exact_rows}/{SEARCH_Q} rows, near-ties only otherwise")
        ms = cuda_ms(lambda: fused_scores_groupmax(q, p, GROUP))
        ms_q64 = cuda_ms(lambda: fused_scores_groupmax(q[:SMALL_Q], p, GROUP))
        plain_ms = cuda_ms(lambda: fused_scores_groupmax_plain(q, p, GROUP), iters=5)
        lib = library_scores(q, p, GROUP)
        # the kernel's operands: int8 passages take int8 queries
        q_bytes = q.numel() * (1 if dtype == torch.int8 else 4)
        nbytes = (q_bytes + p.numel() * p.element_size()
                  + SEARCH_Q * SEARCH_N * 4 + SEARCH_Q * (SEARCH_N // GROUP) * 4)
        bound_ms, bound_by = kernel_bound(2.0 * SEARCH_Q * SEARCH_N * SEARCH_D, nbytes,
                                          torch.int8 if dtype == torch.int8 else torch.float32)
        log(f"    kernel {ms:.3f} ms (Q={SMALL_Q}: {ms_q64:.3f}), plain {plain_ms:.3f} ms, "
            f"{lib['library']} {lib['library_ms']:.3f} ms, matmul alone "
            f"{lib['matmul_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        result = {
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms, **lib,
            "bound_ms": bound_ms, "bound_by": bound_by, f"ms_Q{SMALL_Q}": ms_q64,
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
            entry[f"{dtype_name(dtype)}_storage"] = result
        del s, g, s_ref, g_ref, p
    return entry


def library_scores(q, p, group):
    """One PyTorch call computing kernel 2's function (scores and group
    maxima) and the matrix product alone, both in ms. f32 and bf16:
    ``torch.matmul`` with TF32 off on f32 operands; int8: ``torch._int_mm``
    (s8 x s8 -> s32 on the tensor cores), ``.float()``, ``amax``."""
    qn = q.shape[0]
    if p.dtype == torch.int8:
        qi, pt = q.to(torch.int8), p.T
        mm = lambda: torch._int_mm(qi, pt)  # noqa: E731
        full = lambda: mm().float().view(qn, -1, group).amax(-1)  # noqa: E731
        name = "torch._int_mm + .float() + amax"
    else:
        pf = p.float()
        mm = lambda: torch.matmul(q, pf.T)  # noqa: E731
        full = lambda: mm().view(qn, -1, group).amax(-1)  # noqa: E731
        name = "torch.matmul (TF32 off) + amax"
    return {"library_ms": cuda_ms(full, iters=5), "library": name,
            "matmul_ms": cuda_ms(mm, iters=5)}


def topk_near_ties(top_i, s_ref, qnorm, pnorm_max, k=TOP_N):
    """Top-k indices of a kernel path against the stable top-k of the plain
    scores, as sets: a row may differ only in near-ties at the k-th score,
    within the f32 tolerance 1e-5*|q|*max|p|. Returns the rows equal as sets."""
    ref_s, ref_i = stable_topk(s_ref, k)
    got, ref = top_i.cpu().tolist(), ref_i.cpu().tolist()
    exact = 0
    for r in range(top_i.shape[0]):
        a, b = set(got[r]), set(ref[r])
        if a == b:
            exact += 1
            continue
        tol = 1e-5 * qnorm[r].item() * pnorm_max
        kth = ref_s[r, -1].item()
        for idx in a ^ b:
            if abs(s_ref[r, idx].item() - kth) > tol:
                raise AssertionError(f"top-{k} sets differ in row {r} beyond near-ties")
    return exact


def check_streaming(q32, p32):
    """Kernels 3 and 4 and ``streaming_flat_ip_topk`` over one 524288-row
    block, f32/bf16/int8 passages, G=128 and 32, Q=512 and 64: pass A's
    maxima and pass B's candidates (at 101 groups) equal to kernel 2's; the
    streaming top-100 equal to ``flat_ip_topk``'s in scores and indices;
    against the plain versions within 1e-5*|q|*max|p| (int8: equal) and
    top-100 sets equal up to near-ties. The two counts are zeroed just
    before each ``streaming_flat_ip_topk`` call and read just after."""
    launches = {"streaming_groupmax": 0, "extract_candidate_scores": 0}
    worst = {}
    for dtype in STORAGE:
        q_all, p = search_operands(q32, p32, dtype)
        pnorm_max = p.float().norm(dim=1).max().item()
        for qn in (SEARCH_Q, SMALL_Q):
            q = q_all[:qn]
            qnorm = q.norm(dim=1)
            flat_s, flat_i = flat_ip_topk(q, p, TOP_N, block_rows=SEARCH_N)
            s_plain = fused_scores_groupmax_plain(q, p, STREAM_GROUPS[0])[0]
            for group in STREAM_GROUPS:
                scores, gmax = fused_scores_groupmax(q, p, group)
                g = streaming_groupmax(q, p, group)
                gsel = torch.sort(grouped_topk_last_axis(g, CAND_GROUPS, 32)[1], dim=1)[0]
                cand = extract_candidate_scores(q, p, gsel, group)
                torch.cuda.synchronize()
                want = torch.gather(scores.view(qn, -1, group), 1,
                                    gsel[:, :, None].expand(-1, -1, group))
                if not torch.equal(g, gmax):
                    raise AssertionError(f"pass A maxima != kernel 2's ({dtype}, Q={qn}, G={group})")
                if not torch.equal(cand, want):
                    raise AssertionError(f"pass B scores != kernel 2's ({dtype}, Q={qn}, G={group})")
                err_g = (g - s_plain.view(qn, -1, group).amax(-1)).abs()
                err_c = (cand - extract_candidate_scores_plain(q, p, gsel, group)).abs()
                tol = 1e-5 * qnorm * pnorm_max
                limit = 0.0 if dtype == torch.int8 else None
                for name, err, t in (("maxima", err_g, tol[:, None]),
                                     ("candidates", err_c, tol[:, None, None])):
                    bad = (err.max().item() > limit) if limit is not None else not bool((err <= t).all())
                    if bad:
                        raise AssertionError(f"streaming {name} vs plain ({dtype}, Q={qn}, "
                                             f"G={group}): {err.max().item()}")
                streaming_groupmax.launches = 0
                extract_candidate_scores.launches = 0
                top_s, top_i = streaming_flat_ip_topk(q, p, TOP_N, group=group)
                torch.cuda.synchronize()
                launches["streaming_groupmax"] += streaming_groupmax.launches
                launches["extract_candidate_scores"] += extract_candidate_scores.launches
                if not (torch.equal(top_s, flat_s) and torch.equal(top_i, flat_i)):
                    raise AssertionError(f"streaming top-{TOP_N} != flat_ip_topk "
                                         f"({dtype}, Q={qn}, G={group})")
                exact = topk_near_ties(top_i, s_plain, qnorm, pnorm_max)
                if dtype == torch.int8 and exact != qn:
                    raise AssertionError("int8 streaming top-k sets differ from the plain search")
                log(f"  streaming {dtype_name(dtype)} Q={qn} G={group}: maxima and "
                    f"{CAND_GROUPS}-group candidates equal kernel 2's; top-{TOP_N} equals "
                    f"flat_ip_topk; vs plain max_abs_err {err_g.max().item():.3e}/"
                    f"{err_c.max().item():.3e}, sets equal in {exact}/{qn} rows")
                worst[(dtype, qn, group)] = max(err_g.max().item(), err_c.max().item())
                del scores, gmax, g, cand, want
            del s_plain
        del p, q_all
    torch.cuda.empty_cache()
    return launches, worst


def pass_b_bound(q, p, gsel, group):
    """Kernel 4's bound (ms, what bounds it) for these inputs: the rows of
    the groups ``gsel`` picks read once, the queries and ids read once,
    the [Q, kg, G] f32 scores written once; 2 * Q * kg * G * D operations
    at the f32 peak (int8 passages: at the int8 tensor-core peak)."""
    picked = int(torch.unique(gsel).numel())
    nbytes = (picked * group * p.shape[1] * p.element_size() + q.numel() * q.element_size()
              + gsel.numel() * gsel.element_size() + gsel.numel() * group * 4)
    return kernel_bound(2.0 * gsel.numel() * group * p.shape[1], nbytes,
                        torch.int8 if p.dtype == torch.int8 else torch.float32)


def pass_b_times(q, p, gsel, group):
    """Kernel 4 at one configuration: the public entry host-paced, the
    streaming search's entry on the device, and the bound."""
    bound = pass_b_bound(q, p, gsel, group)
    return {"ms": cuda_ms(lambda: extract_candidate_scores(q, p, gsel, group)),
            "device_ms": device_ms(
                lambda: extract_candidate_scores_unchecked(q, p, gsel, group)),
            "bound_ms": bound[0], "bound_by": bound[1]}


def check_work_list(gsel, n_groups):
    """Kernel 4's work list (the counting sort on the card) against its
    plain version: items equal, the slots of each group equal up to their
    order. Returns its item count, bound and device time."""
    slots, items, n_items = candidate_work_list(gsel, n_groups)
    want_slots, want_items, want_n = candidate_work_list_plain(gsel, n_groups)
    n = int(n_items[0])
    flat = gsel.reshape(-1).long()
    by_group, want_by_group = flat[slots.long()], flat[want_slots.long()]
    key = lambda g, sl: torch.sort(g * flat.numel() + sl)[0]  # noqa: E731
    if not (torch.equal(n_items, want_n) and torch.equal(items[:n], want_items[:n])
            and torch.equal(by_group, want_by_group)
            and torch.equal(key(by_group, slots), key(want_by_group, want_slots))):
        raise AssertionError("pass B work list differs from its plain version")
    return {"items": n, "bound": items.shape[0], "equals_plain": True,
            "device_ms": device_ms(lambda: candidate_work_list(gsel, n_groups))}


def time_streaming(q, p, worst, launches):
    """Kernels 3 and 4 at Q=512 G=128 f32 (kernel 4 at the 101 groups pass A
    picks), with the kernel-2 counterparts and the whole streaming top-100
    against flat_ip_topk at Q=512 and 64."""
    group = STREAM_GROUPS[0]
    n_groups = SEARCH_N // group
    gmax = streaming_groupmax(q, p, group)
    gsel = torch.sort(grouped_topk_last_axis(gmax, CAND_GROUPS, 32)[1], dim=1)[0]
    idx = gsel[:, :, None].expand(-1, -1, group)
    picked = int(torch.unique(gsel).numel())
    bound3 = kernel_bound(2.0 * SEARCH_Q * SEARCH_N * SEARCH_D,
                          q.numel() * 4 + p.numel() * 4 + SEARCH_Q * n_groups * 4)
    k3 = {
        "name": "streaming_groupmax", "route": "cuda",
        "source": "convdr_torch/csrc/scores_groupmax.cu (convdr_streaming_groupmax)",
        "replaces": "convdr_tpu/ops/pallas_search.py:366",
        "launches": launches["streaming_groupmax"],
        "max_abs_err": worst[(torch.float32, SEARCH_Q, group)],
        "ms": cuda_ms(lambda: streaming_groupmax(q, p, group)),
        "plain_ms": cuda_ms(lambda: streaming_groupmax_plain(q, p, group), iters=5),
        **library_scores(q, p, group),
        "bound_ms": bound3[0], "bound_by": bound3[1],
        "shape": f"Q={SEARCH_Q} N={SEARCH_N} D={SEARCH_D} G={group} f32",
        "ms_by_config": {
            f"Q{SMALL_Q}_G{group}_f32": cuda_ms(lambda: streaming_groupmax(q[:SMALL_Q], p, group)),
            f"Q{SEARCH_Q}_G32_f32": cuda_ms(lambda: streaming_groupmax(q, p, 32)),
        },
    }
    k4 = {
        "name": "extract_candidate_scores", "route": "cuda",
        "source": "convdr_torch/csrc/streaming_search.cu",
        "replaces": "convdr_tpu/ops/pallas_search.py:462",
        "launches": launches["extract_candidate_scores"],
        "max_abs_err": worst[(torch.float32, SEARCH_Q, group)],
        # the public entry, host-paced: its range check waits for the kernel
        "ms": cuda_ms(lambda: extract_candidate_scores(q, p, gsel, group)),
        # the entry the streaming search calls, on the device: work list + kernel
        "device_ms": device_ms(lambda: extract_candidate_scores_unchecked(q, p, gsel, group)),
        "plain_ms": cuda_ms(lambda: extract_candidate_scores_plain(q, p, gsel, group), iters=3),
        "library_ms": cuda_ms(lambda: torch.gather(
            torch.matmul(q, p.T).view(SEARCH_Q, -1, group), 1, idx), iters=5),
        "library": "torch.matmul + torch.gather (the score-matrix path)",
        **dict(zip(("bound_ms", "bound_by"), pass_b_bound(q, p, gsel, group))),
        "shape": f"Q={SEARCH_Q} kg={CAND_GROUPS} G={group} D={SEARCH_D} f32, "
                 f"{picked} of {n_groups} groups picked",
        "work_list": check_work_list(gsel, n_groups),
        "ms_by_config": {f"Q{SMALL_Q}_G{group}_f32": pass_b_times(
            q[:SMALL_Q], p, gsel[:SMALL_Q], group)},
    }
    for dtype in STORAGE[1:]:  # bf16 and int8 passages
        qd, pd = search_operands(q, p, dtype)
        for qn in (SEARCH_Q, SMALL_Q):
            k3["ms_by_config"][f"Q{qn}_G{group}_{dtype_name(dtype)}"] = cuda_ms(
                lambda: streaming_groupmax(qd[:qn], pd, group))
            k4["ms_by_config"][f"Q{qn}_G{group}_{dtype_name(dtype)}"] = pass_b_times(
                qd[:qn], pd, gsel[:qn], group)
        del qd, pd
    e2e = {}
    for qn in (SEARCH_Q, SMALL_Q):
        e2e[f"Q{qn}"] = {
            "streaming_G128_ms": cuda_ms(lambda: streaming_flat_ip_topk(q[:qn], p, TOP_N), iters=5),
            "streaming_G32_ms": cuda_ms(
                lambda: streaming_flat_ip_topk(q[:qn], p, TOP_N, group=32), iters=5),
            "flat_ip_topk_ms": cuda_ms(
                lambda: flat_ip_topk(q[:qn], p, TOP_N, block_rows=SEARCH_N), iters=5),
            # the searcher's default scan block is the whole 524288-row block
            "streaming_G128_peak_mib": peak_mib(lambda: streaming_flat_ip_topk(q[:qn], p, TOP_N)),
            "flat_ip_topk_peak_mib": peak_mib(
                lambda: flat_ip_topk(q[:qn], p, TOP_N, block_rows=SEARCH_N)),
        }
    k3["top100_ms"] = e2e
    log(f"  pass A {k3['ms']:.3f} ms (bound {bound3[0]:.3f}; {k3['library']} "
        f"{k3['library_ms']:.3f}, matmul alone {k3['matmul_ms']:.3f}; by config "
        + ", ".join(f"{c} {v:.3f}" for c, v in k3["ms_by_config"].items())
        + f"), pass B {k4['ms']:.3f} ms host-paced, {k4['device_ms']:.3f} on the device "
        f"(bound {k4['bound_ms']:.3f}, {k4['bound_by']}; {picked}/{n_groups} groups picked; "
        f"work list {k4['work_list']['items']} items, {k4['work_list']['device_ms']:.4f} ms; "
        f"by config " + ", ".join(
            f"{c} {v['ms']:.3f}/{v['device_ms']:.3f} (bound {v['bound_ms']:.3f})"
            for c, v in k4["ms_by_config"].items()) + f"); top-{TOP_N} "
        + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.2f}" for n, v in d.items())
                    for k, d in e2e.items()))
    return k3, k4


def check_and_time_gather(q, p):
    """Kernel 5 against ``torch.gather`` at Q=512, B=524288, K=101, G=32 on
    kernel 2's scores and the groups its maxima pick; then
    ``flat_ip_topk(gather="dma")`` over the same block equal to
    ``gather="auto"`` (the argument selects no code: both launch the
    kernel). Its launches on the path are counted in ``main_path``."""
    scores, gmax = fused_scores_groupmax(q, p, GROUP)
    gsel = torch.sort(grouped_topk_last_axis(gmax, CAND_GROUPS, 32)[1], dim=1)[0]
    out = dma_gather_groups(scores, gsel, group=GROUP)
    torch.cuda.synchronize()
    if not torch.equal(out, dma_gather_groups_plain(scores, gsel, group=GROUP)):
        raise AssertionError("the group gather differs from torch.gather")
    dma = flat_ip_topk(q, p, TOP_N, block_rows=SEARCH_N, gather="dma")
    auto = flat_ip_topk(q, p, TOP_N, block_rows=SEARCH_N)
    if not (torch.equal(dma[0], auto[0]) and torch.equal(dma[1], auto[1])):
        raise AssertionError("flat_ip_topk(gather='dma') != 'auto'")
    moved = out.numel() * 4
    bound = kernel_bound(0.0, 2 * moved + gsel.numel() * 8)
    plain_ms = cuda_ms(lambda: dma_gather_groups_plain(scores, gsel, group=GROUP))
    entry = {
        "name": "dma_gather_groups", "route": "cuda",
        "source": "convdr_torch/csrc/gather_groups.cu",
        "replaces": "convdr_tpu/ops/pallas_search.py:256",
        "launches": 0, "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: dma_gather_groups(scores, gsel, group=GROUP)),
        "plain_ms": plain_ms,
        "library_ms": plain_ms,  # the plain version is one torch.gather
        "bound_ms": bound[0], "bound_by": bound[1],
        "shape": f"Q={SEARCH_Q} B={SEARCH_N} K={CAND_GROUPS} G={GROUP} f32",
        # ms above is host-paced at this size; these are the device's times
        "device_ms": device_ms(lambda: dma_gather_groups(scores, gsel, group=GROUP)),
        "plain_device_ms": device_ms(lambda: dma_gather_groups_plain(scores, gsel, group=GROUP)),
        "launch_config": gather_config(scores, gsel, GROUP),
        # host time of one call, enqueue only (the calls queue behind a spin)
        "host_us": {"kernel": host_us(lambda: dma_gather_groups(scores, gsel, group=GROUP)),
                    "torch.gather": host_us(
                        lambda: dma_gather_groups_plain(scores, gsel, group=GROUP))},
        "flat_ip_topk_ms": {
            "dma": cuda_ms(lambda: flat_ip_topk(q, p, TOP_N, block_rows=SEARCH_N, gather="dma"),
                           iters=5),
            "auto": cuda_ms(lambda: flat_ip_topk(q, p, TOP_N, block_rows=SEARCH_N), iters=5),
        },
    }
    log(f"  group gather Q={SEARCH_Q} K={CAND_GROUPS} G={GROUP}: equals torch.gather; "
        f"kernel {entry['ms'] * 1e3:.1f} us (device {entry['device_ms'] * 1e3:.1f}, host "
        f"{entry['host_us']['kernel']:.1f}), torch.gather {plain_ms * 1e3:.1f} us (device "
        f"{entry['plain_device_ms'] * 1e3:.1f}, host {entry['host_us']['torch.gather']:.1f}), bound "
        f"{bound[0] * 1e3:.1f} us; flat_ip_topk dma/auto equal, "
        f"{entry['flat_ip_topk_ms']['dma']:.2f}/{entry['flat_ip_topk_ms']['auto']:.2f} ms")
    del scores, gmax, out
    return entry


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
class ForwardShapes:
    """Counts the forward kernel's launches by (dtype, T) while active,
    through a shim around ``attention.flash_attention_fwd``, the one
    function every forward launch goes through (inference and training).
    The kernel's own count stays ``flash_attention.launches``; on exit the
    two must agree."""

    def __enter__(self):
        self.counts = collections.Counter()
        self.real = attention.flash_attention_fwd
        self.before = flash_attention.launches

        def counted(q, k, v, mask, with_lse):
            out = self.real(q, k, v, mask, with_lse)
            self.counts[f"{dtype_name(q.dtype)}_T{q.shape[1]}"] += 1
            return out

        attention.flash_attention_fwd = counted
        return self.counts

    def __exit__(self, *exc):
        attention.flash_attention_fwd = self.real
        if exc[0] is None and sum(self.counts.values()) != flash_attention.launches - self.before:
            raise AssertionError(f"forward launches by shape {dict(self.counts)} != "
                                 f"{flash_attention.launches - self.before}")


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


def load_rows(emb_dir):
    """All blocks of a dir on the card, in block order: rows (f32) and offsets."""
    rows, offs = [], []
    for _b, emb, ids in iter_embedding_blocks(emb_dir):
        rows.append(torch.from_numpy(emb).cuda().float())
        offs.append(torch.from_numpy(ids.astype(np.int64)).cuda())
    return torch.cat(rows), torch.cat(offs)


def reference_check(work, processed, raw, emb_dir, trec):
    """The inference run file against an exact plain-PyTorch search: the same
    query encoder, one f32 matmul over all rows, a stable sort. Returns the
    qids and query embeddings."""
    args = run_convdr_inference.get_arguments(inference_argv(work, processed, raw, emb_dir))
    qids, q_embs, _ = run_convdr_inference.encode_queries(
        args, args.model_path, args.eval_file, torch.float32, torch.device("cuda")
    )
    rows, offs = load_rows(emb_dir)
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
    return qids, q_embs


def inference_argv(work, processed, raw, emb_dir, run_name="run"):
    return [
        "--model_path", "init", "--model_type", "rdot_nll",
        "--eval_file", os.path.join(raw, "eval_topics.jsonl"),
        "--ann_data_dir", emb_dir, "--processed_data_dir", processed,
        "--raw_data_dir", raw, "--qrels", os.path.join(raw, "qrels.tsv"),
        "--output_trec_file", os.path.join(work, f"{run_name}.trec"),
        "--output_query_type", "raw", "--query", "no_res",
        "--max_concat_length", "256", "--top_n", str(TOP_N),
    ]


def main_path(gen):
    shutil.rmtree(WORK, ignore_errors=True)
    processed, raw = make_inputs(WORK)
    emb_dir = os.path.join(WORK, "embeddings")
    flash_attention.launches = 0
    fused_scores_groupmax.launches = 0
    dma_gather_groups.launches = 0
    with ForwardShapes() as by_shape:
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
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches,
                "flash_attention_fwd_by_shape": dict(sorted(by_shape.items()))}
    log(f"  embedded {rows} passages in {t_embed:.1f} s; inference + search over "
        f"{rows + 2 * N_EXTRA} rows in {t_infer:.1f} s; launches {launches}")
    if rows != N_PASSAGES or min(v for v in launches.values() if isinstance(v, int)) == 0:
        raise AssertionError(f"main path did not run through its kernels: {launches}")
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
    qids, q_embs = reference_check(WORK, processed, raw, emb_dir, trec)
    paths = {"processed": processed, "raw": raw, "emb_dir": emb_dir, "trec": trec}
    return launches, metrics, t_embed, t_infer, (paths, qids, q_embs)


def int8_path(paths, qids, q_embs):
    """The SQ8 user path at the same width: int8 embed (block 0 through the
    driver, the two extra blocks quantized with its sidecar), an int8 search
    held index for index to an integer-exact plain search of the same rows,
    and an int8 search of the f32 blocks refined on the host. The score
    kernel's count is zeroed before the two searches and read after."""
    processed, raw, emb_dir = paths["processed"], paths["raw"], paths["emb_dir"]
    emb_i8 = os.path.join(WORK, "embeddings_i8")
    t0 = time.time()
    gen_passage_embeddings.main([
        "--data_dir", processed, "--checkpoint", "init", "--model_type", "rdot_nll",
        "--output_dir", emb_i8, "--per_gpu_eval_batch_size", "64",
        "--dtype", "bfloat16", "--num_blocks", "1", "--storage_dtype", "int8",
    ])
    t_embed = time.time() - t0
    quant = Int8Quantizer.load(emb_i8)  # the driver's sidecar
    for block_id, emb, ids in iter_embedding_blocks(emb_dir):
        if block_id == 0:
            continue
        write_embedding_block(emb_i8, block_id, quant.quantize_passages(emb), ids)
    blocks = [(b, emb.dtype, emb.shape) for b, emb, _ in iter_embedding_blocks(emb_i8)]
    if [d for _, d, _ in blocks] != [np.int8] * 3 or blocks[0][2] != (N_PASSAGES, SEARCH_D):
        raise AssertionError(f"int8 blocks: {blocks}")

    fused_scores_groupmax.launches = 0
    t0 = time.time()
    run_convdr_inference.main(inference_argv(WORK, processed, raw, emb_i8, "run_i8")
                              + ["--storage_dtype", "int8"])
    torch.cuda.synchronize()
    t_i8 = time.time() - t0
    t0 = time.time()
    run_convdr_inference.main(inference_argv(WORK, processed, raw, emb_dir, "run_rs")
                              + ["--storage_dtype", "int8", "--rescore_factor", "2"])
    torch.cuda.synchronize()
    t_rescore = time.time() - t0
    launches = fused_scores_groupmax.launches
    if launches == 0:
        raise AssertionError("the int8 searches did not launch the score kernel")

    # int8: the integer-exact plain search of the same rows, index for index
    rows, offs = load_rows(emb_i8)
    q_int = torch.from_numpy(quant.quantize_queries(q_embs)[0]).cuda()
    _s, top_i = stable_topk(q_int @ rows.T, TOP_N)
    want = (offs[top_i] + 1000).cpu().numpy()
    run = parse_trec_run(os.path.join(WORK, "run_i8.trec"))
    for r, qid in enumerate(qids):
        if [pid for pid, _ in run[qid]] != want[r].tolist():
            raise AssertionError(f"{qid}: int8 run differs from the integer-exact search")
    log(f"  int8 run equals the integer-exact plain search index for index for "
        f"{len(qids)}/{len(qids)} queries")

    # int8 + rescore over the f32 blocks, index for index against a run
    # built without the searcher; overlap with the exact f32 run
    want = rescore_reference(emb_dir, q_embs)
    rescored = parse_trec_run(os.path.join(WORK, "run_rs.trec"))
    exact = parse_trec_run(paths["trec"])
    overlap = []
    for r, qid in enumerate(qids):
        pids = [pid for pid, _ in rescored[qid]]
        if pids != want[r].tolist():
            raise AssertionError(f"{qid}: the int8 + rescore run differs from the reference")
        overlap.append(len(set(pids) & {pid for pid, _ in exact[qid]}) / TOP_N)
    log(f"  int8 + rescore 2 run equals the host-quantized, integer-exact, f32-refined "
        f"reference index for index for {len(qids)}/{len(qids)} queries; top-{TOP_N} "
        f"overlap with the exact f32 run {float(np.mean(overlap)):.4f}")
    return {"score_kernel_launches": launches, "embed_s": t_embed, "inference_s": t_i8,
            "inference_rescore_s": t_rescore, "rescore_overlap": float(np.mean(overlap))}


def rescore_reference(emb_dir, q_embs, factor=2):
    """The ``--storage_dtype int8 --rescore_factor`` run over float blocks,
    built without the searcher: scales self-fitted on block 0, each block
    quantized on the host (numpy), its integer-exact top ``factor * k`` by
    an f32 matmul of the int-valued operands (exact) and a stable sort,
    those rows refined in f32 on the host, then a stable merge of the
    blocks in order (an earlier block first on ties). Returns pids [Q, k]."""
    blocks = list(iter_embedding_blocks(emb_dir))
    quant = Int8Quantizer.fit(blocks[0][1])
    q_int = torch.from_numpy(quant.quantize_queries(q_embs)[0]).cuda()
    scores, pids = [], []
    for _b, emb, ids in blocks:
        p_int = torch.from_numpy(quant.quantize_passages(emb)).cuda().float()
        cand = stable_topk(q_int @ p_int.T, factor * TOP_N)[1].cpu().numpy()
        del p_int
        s, i = rescore_candidates(q_embs, emb, cand, TOP_N)
        scores.append(s)
        pids.append(ids.astype(np.int64)[i] + 1000)
    scores, pids = np.concatenate(scores, 1), np.concatenate(pids, 1)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :TOP_N]
    return np.take_along_axis(pids, order, 1)


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
        with ForwardShapes() as by_shape:
            t0 = time.time()
            outputs = run_convdr_train.main(argv)
            torch.cuda.synchronize()
            t_train = time.time() - t0
        launches = {"flash_attention_fwd": flash_attention.launches,
                    "flash_attention_bwd": flash_attention_bwd.launches}
    finally:
        run_convdr_train.run_training = real_run_training
    log(f"  trained {TRAIN_STEPS} steps in {t_train:.1f} s (model init and "
        f"checkpoints included); launches {launches}, forward by shape {dict(by_shape)}")
    want = {"flash_attention_fwd": 36 * TRAIN_STEPS, "flash_attention_bwd": 12 * TRAIN_STEPS}
    if outputs != [out_dir] or launches != want:
        raise AssertionError(f"training path: outputs {outputs}, launches {launches} != {want}")
    launches["flash_attention_fwd_by_shape"] = dict(sorted(by_shape.items()))
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
    configs = build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log("kernel checks against the plain versions:")
    worst = check_attention(gen)
    kernels = [time_attention(gen, worst)]
    q32 = torch.randn(SEARCH_Q, SEARCH_D, generator=gen, device="cuda")
    p32 = torch.randn(SEARCH_N, SEARCH_D, generator=gen, device="cuda")
    kernels.append(check_and_time_search(q32, p32))
    log("the streaming search and the group gather (one 524288-row block, D=768):")
    t0 = time.time()
    stream_launches, stream_worst = check_streaming(q32, p32)
    kernels.extend(time_streaming(q32, p32, stream_worst, stream_launches))
    kernels.append(check_and_time_gather(q32, p32))
    t_stream = time.time() - t0
    del q32, p32
    torch.cuda.empty_cache()
    log("inference path (full RoBERTa-base width, seeded weights):")
    try:
        launches, metrics, t_embed, t_infer, (paths, qids, q_embs) = main_path(gen)
        torch.cuda.empty_cache()
        log("int8 (SQ8) path through the same drivers:")
        int8 = int8_path(paths, qids, q_embs)
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
    fwd, search, k3, k4, k5, bwd = kernels
    for entry, source, config in ((fwd, "flash_attention", "flash_attention_fwd"),
                                  (search, "scores_groupmax", "scores_groupmax"),
                                  (k3, "scores_groupmax", "scores_groupmax"),
                                  (k4, "streaming_search", "extract_candidate_scores"),
                                  (k5, "gather_groups", None),
                                  (bwd, "flash_attention_bwd", "flash_attention_bwd")):
        entry["ptxas"] = ptxas_summary(source)
        if config:
            entry["launch_config"] = configs[config]
    k5["launches"] = launches["dma_gather_groups"]
    fwd["launches"] = launches["flash_attention_fwd"]
    fwd["launches_by_path"] = {"inference": launches["flash_attention_fwd"],
                               "train": train_launches["flash_attention_fwd"]}
    fwd["launches_by_shape"] = {"inference": launches["flash_attention_fwd_by_shape"],
                                "train": train_launches["flash_attention_fwd_by_shape"]}
    search["launches"] = launches["fused_scores_groupmax"]
    search["launches_by_path"] = {"inference_f32": launches["fused_scores_groupmax"],
                                  "inference_int8_and_rescore": int8["score_kernel_launches"]}
    bwd["launches"] = train_launches["flash_attention_bwd"]
    log(f"inference + search over {N_PASSAGES + 2 * N_EXTRA} rows, same call: f32 "
        f"{t_infer:.2f} s, int8 {int8['inference_s']:.2f} s, int8 + rescore 2 over the f32 "
        f"blocks {int8['inference_rescore_s']:.2f} s; embed f32 {t_embed:.2f} s, int8 "
        f"{int8['embed_s']:.2f} s; streaming + gather phase {t_stream:.1f} s")
    attn_ms = bwd["train_step_attention_ms"]["x12_layers"]
    log(f"training: {train['ms_per_step']:.1f} ms/step, {train['examples_per_s']:.1f} "
        f"examples/s (batch {TRAIN_B}, {TRAIN_NEG} negatives, concat {TRAIN_T}, docs <= "
        f"{DOC_T}); attention kernels at the step's shapes {attn_ms:.2f} ms "
        f"({100 * attn_ms / train['ms_per_step']:.1f}% of a step); the step's device parts "
        f"{sum(step_check['phases_ms'].values()):.1f} ms, the rest (input pipeline, "
        f"metrics, host) {train['ms_per_step'] - sum(step_check['phases_ms'].values()):.1f} ms")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its path")
    result = {"kernels": kernels}
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": smi, "metrics": metrics, "embed_s": t_embed,
                       "inference_s": t_infer, "int8": int8, "streaming_phase_s": t_stream,
                       "launch_configs": configs,
                       "train": train, "train_step_check": step_check,
                       "total_s": time.time() - t_start}, f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
