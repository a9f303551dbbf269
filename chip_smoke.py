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
F. (after 3b) The raw-input chain at full width: seeded raw CAsT-19 files
   (a TREC-CAR paragraphs CBOR of 4096 paragraphs written with the port's
   ``encode_item``, a 4096-passage MARCO tsv with 256 duplicates listed,
   20 topics x 4 turns of topic JSON / TSV and qrels) through ``python -m
   convdr_torch.etl.cast19`` (its seconds and every output's sha256
   printed), the tokenize driver, ``gen_passage_embeddings`` (bf16) and
   ``run_convdr_inference`` (exact f32): CAR pids from 10,000,000 reach
   the run through offset2pid, the ETL's qrels score it (the metrics
   recomputed; each turn's top pid written back as a CAR_/MARCO_ qrel and
   remapped gives MRR 1), the run rank for rank an exact plain search of
   the same rows, kernels 1, 2 and 5 counted from zero around the drivers.
P. (after F) ``--matmul_precision`` over phase 3's rows and queries:
   ``flat_ip_topk`` at "highest", "high" (a TF32 product) and "default"
   (bf16 operands, f32 out) timed over one 524288-row block at Q=512, with
   the product, the bf16 cast and the group maxima alone; each reduced
   precision's scores not bit-equal to "highest"'s, their normalized error
   within the rounding's bound, "default" within 1e-5 of its plain
   emulation, and the top-100 overlap with "highest" over all rows at least
   0.99 ("high") / 0.95 ("default"); ``run_convdr_inference
   --matmul_precision default`` against phase 3's run (kernel 2 not
   launched, kernel 5 launched); ``OnlineSearcher`` at "default" and
   "highest" over 16 turns, every replay bit-equal to its eager program,
   their overlap; then the "highest" search again, bit for bit the first.
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
4b. The data plane at the same width: a raw ``collection.tsv`` of 8192
   seeded passages (4-110 words of a fixed list; the longer ones pass the
   512-token cap) through ``tokenize_collection.main`` (8 spawned workers,
   the main path's 512 queries through ``--queries``; run in a fresh
   interpreter, whose workers import no ``torch``), with the native split
   merge held byte for byte to the plain one; ``gen_passage_embeddings.main
   --dtype bfloat16 --storage_dtype bfloat16 --block_format native`` (one
   ``.cnb`` file of half the f32 bytes plus ids and header); then
   ``run_convdr_inference.main --storage_dtype bfloat16 --profile_dir``,
   whose run is held to an exact plain search of the same bf16 rows (top-100
   sets, near-ties at the cut), the score kernel checked at this shape, and
   the search phase's ``torch.profiler`` trace read for its launches by
   kernel and its device-busy share (the union of kernel intervals over the
   span's wall time). The kernels' counts are zeroed before the embed and
   read after the search.
4c. The port's quality rehearsal, ``convdr_torch.scripts.rehearsal --smoke``
   (tiny width: tokenize, embed, teacher run, ranking data, 500 KD +
   ranking steps, inference), whose asserts decide: zero oracle mismatches,
   NDCG@3 and MRR higher after training. Counts zeroed before, read after.
4d. The ANN family at D=768 (PyTorch ops; no hand-written kernel of its
   own): 1,048,576 seeded rows of a 4096-centre Gaussian mixture and 512
   queries from it, the rows written as two f32 ``.cnb`` blocks. IVF f32
   (nlist 1024, slack 1, 20 k-means iterations) through
   ``build_from_blocks``, its build timed by stage; a full probe whose
   top-100 sets equal ``flat_ip_topk``'s (near-ties at the cut), then
   nprobe 8, 32, 128 (recall@100, ms, peak MiB). IVF int8 over the same
   rows: a full probe equal to the integer-exact plain search score for
   score. Flat pq4 (m 96, packed) at Q=512 and flat pq8 (m 96) at Q=64,
   and IVFPQ through ``from_pq_index``: ADC top-100 sets equal to
   ``pq_adc_oracle``'s sum (on the card, checked bit for bit against the
   numpy oracle on two queries), recall@100 and ms; ``--rescore_factor 2``
   over the pq4 candidates through the refine store on the ``.cnb`` blocks,
   equal index for index to a plain refine. Then the drivers:
   ``build_ivf_index.main`` over the phase-3 f32 blocks and
   ``run_convdr_inference.main --ivf_dir --nprobe 999``, whose metrics equal
   the flat f32 run's, and ``--nprobe 1``; kernel 1's count is zeroed
   before the full-probe run and read after (> 0).
4e. Online serving (``convdr_torch.retrieval.online``): 64 distinct
   three-turn histories served one turn at a time, each turn one replay of
   the captured CUDA graph of the whole program (encode at concat 256,
   query-side prep, search), by seven resident backends: the inference
   path's 1,056,768 rows flat in f32, bf16 and int8, and the ANN phase's
   IVF int8 and packed IVFPQ pq4 indexes at nprobe 8 and 32. For each: the
   build and capture seconds, resident and graph-pool MiB, p50 / p90 / p99
   ms of ``search`` (tokenize included), of ``search_tokens`` and of the
   same turns run eagerly in two steps (encode, read back, search), the
   device ms of a replay, of the encode and of the search; every replay
   equal bit for bit to the eager program. Kernel 1 at B=1 T=256 f32 and
   kernel 2 at Q=1 (f32, bf16, int8) against their plain versions, bounds
   and library calls. Then ``serve_online.main`` over the 512 evaluation
   turns against ``run_convdr_inference --per_gpu_eval_batch_size 1``
   (flat f32 and int8): the runs rank for rank. The serving launches are
   counted from zero around each backend: each graph's recorded launches
   times its replays, plus the eager run before its capture.
4f. bf16 training (run right after phase 4): kernel 1 in bf16 with its lse
   at B=4 T=256, B=4 T=64 and B=5 T=200 under every mask kind (lse within
   1e-5 relative of the plain log-sum-exp, out bit-identical to the launch
   without lse); kernel 1b in bf16 at the backward's four shapes under
   every mask kind (each gradient within 2x the error of autograd through
   masked SDPA in bf16, floor 1e-3 of scale, from an f64 plain witness; two
   calls bit-identical; its D pre-pass within 1e-5 of each row's sum of
   |o dO| from the f32 sum); both timed at B=4 T=256 (the backward at B=40
   T=512 too) host-paced and on the device beside the plain version,
   masked SDPA and the bound at the bf16 peaks. One full-width KD + ranking
   step in bf16 (f32 master weights) through the kernels, the plain version
   and SDPA, each held to the f64 step (the kernels' readings within 2x the
   larger of the other two), and its parts timed. Then
   ``run_convdr_train.main --dtype bfloat16`` with phase 4's settings
   (counts zeroed before, read after; the backward's > 0; losses finite;
   the output dir reloads for bf16 inference and encodes a fixed batch as
   the in-memory student does), and ``--use_dropout`` for 4 steps twice
   (finite losses, the teacher's forwards through kernel 1, one seed the
   same losses).
C. Multi-GPU at world size 1 (the card holds one NCCL rank): the
   phase-3 drivers under ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` (each forms its ``("data",)`` or ``("index",)``
   mesh over NCCL, checked): the meshed embed's block equal to phase 3's
   (offsets, rows within 1e-5) and the meshed inference's TREC run
   byte-identical to phase 3's; ``sharded_flat_ip_topk`` on a world-1 NCCL
   mesh and the S=4 and S=3 emulation in this process (each shard's local
   search, kernels 2 and 5 at a nonzero base, then the merge) over one
   524,288-row block at Q=512, f32 and int8, ``torch.equal`` to the
   unsharded ``flat_ip_topk``; phase 4's full-width step over a world-1
   ``("data",)`` mesh bit-identical to the unmeshed step. Prints the NCCL
   all-gather time of the [1, 512, 100] lists, the sharded and unsharded
   search times and the phase's seconds; the kernels' counts are zeroed
   before and read after (the torchrun ranks print theirs).
O. (after 4) The JAX package's orbax checkpoints: (a) the committed
   JAX-written fixture ``tests/fixtures_torch/jax_orbax_tiny`` (the tiny
   model's TrainState with accumulation 2) decoded by the port's zstd /
   OCDBT / zarr reader (the decoder built by g++ here) to the sha256 of
   every array recorded beside it; (b) phase 4's full-width f32 TrainState
   after 2 steps saved with ``save_orbax_checkpoint`` and restored into a
   fresh state, every parameter and moment ``torch.equal``; (c)
   ``run_convdr_inference --model_path <orbax dir>`` over phase 3's blocks
   and topics, its TREC run byte-identical to the one from the same
   weights as the port's own model dir; (d) ``run_convdr_train --resume``
   2 steps from the orbax ``checkpoint-2`` and from ``train_state.pt``,
   losses and parameters bit-identical. Prints the dir's bytes, write and
   read s, the decoder's MB/s, the peak RSS over the read and the phase's
   seconds; kernels 1, 1b, 2 and 5 are counted from zero around it.
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
import hashlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from convdr_torch.core.device import set_exact_matmul
from convdr_torch.data.token_cache import (
    TokenCache,
    TokenCacheWriter,
    load_offset2pid,
    save_id_maps,
)
from convdr_torch.core.config import TrainConfig
from convdr_torch.core.loading import (
    gelu_arch_overrides,
    load_model_and_params,
    load_tokenizer_for,
)
from convdr_torch.core.registry import get_model_config
from convdr_torch.drivers import (
    build_ivf_index,
    gen_passage_embeddings,
    run_convdr_inference,
    run_convdr_train,
    serve_online,
)
from convdr_torch.data.collection import load_qrels
from convdr_torch.etl.cbor_car import encode_item
from convdr_torch.etl.common import CAR_BASE_ID, remap_qrels
from convdr_torch.evaluation.metrics import evaluate_run, mean_metrics, parse_trec_run
from convdr_torch.models import attention, transformer
from convdr_torch.models.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_config,
    flash_attention_bwd_delta,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_config,
    flash_attention_plain,
)
from convdr_torch.ops import cuda_build
from convdr_torch.ops.exact_search import (
    flat_ip_topk,
    grouped_topk_last_axis,
    rounded_scores,
    rounded_scores_plain,
    select_from_groupmax,
    stable_topk,
)
from convdr_torch.ops.fused_search import (
    ROW_TILE,
    fused_scores_groupmax,
    fused_scores_groupmax_plain,
)
from convdr_torch.ops.gather_groups import dma_gather_groups, dma_gather_groups_plain
from convdr_torch.ops.pq import pq_adc_oracle, round_lut, unpack_codes_4bit
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
from convdr_torch.retrieval import ivf as ivf_module
from convdr_torch.retrieval.blocks import host_tensor, iter_embedding_blocks, write_embedding_block
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.online import (
    COUNTED_KERNELS,
    OnlineSearcher,
    capture,
    history_to_inputs,
)
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_torch.scripts import rehearsal
from convdr_torch.scripts.multi_gpu_check import make_train_file
from convdr_torch import native_io
from convdr_torch.train import checkpoint as train_checkpoint
from convdr_torch.train.losses import kd_mse_loss, ranking_nll_loss
from convdr_torch.train.trainer import create_train_state, make_train_step
from convdr_torch.utils.ocdbt import OcdbtReader
from convdr_torch.utils.observability import TRACE_SPAN, profile_trace

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
# the ANN phase: mixture rows and centres, queries (pq8: fewer, see there),
# IVF lists and probes; the driver's index over the phase-3 blocks has few
# enough sub-lists (<= 2 * 256) for --nprobe 999 to probe them all
ANN_N, ANN_CENTRES, ANN_Q, PQ8_Q = 1 << 20, 4096, 512, 64
ANN_NLIST, ANN_NPROBES, DRIVER_NLIST = 1024, (8, 32, 128), 256
# what an IVF search may hold above the index (``max_candidate_bytes`` and
# ``_ADC_CHUNK_BYTES`` at their defaults), plus the [Q, nprobe * cap]
# scores, row ids and top-k of a query chunk
ANN_BUDGET_MIB, ADC_BUDGET_MIB, ANN_SLACK_MIB = 2048, 256, 256
# the serving phase: distinct three-turn histories served one at a time,
# the IVF probes, and the ANN phase's indexes, saved for it
SERVE_TURNS, SERVE_NPROBES, SERVE_T = 64, (8, 32), 256
# the served flat corpus is scanned in SEARCH_N-row blocks; its last is short
SERVE_SHORT = (N_PASSAGES + 2 * N_EXTRA) % SEARCH_N
SERVE_IVF_DIRS = {"ivf_int8": os.path.join(WORK, "serve_ivf_int8"),
                  "ivfpq_pq4": os.path.join(WORK, "serve_ivfpq_pq4")}


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
    configs = {f"{dtype_name(dtype)}_B{batch}xT{t}": flash_attention_bwd_config(
        batch, t, HEADS, HEAD_DIM, dtype)
        for dtype in (torch.float32, torch.bfloat16) for batch, t in BWD_SHAPES}
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


def attention_bound_ms(q, mask, lse=False):
    """Bytes (q, k, v, out, mask once each, and the f32 lse written with
    ``lse``) vs the operations this data needs: a query attends to the L
    valid or the T-L pad keys of its row."""
    b, t, h, d = q.shape
    lens = mask.sum(1).double()
    pairs = float((lens ** 2 + (t - lens) ** 2).sum())
    flops = 4.0 * h * d * pairs
    nbytes = 4 * q.numel() * q.element_size() + mask.numel() * 4 + (b * h * t * 4 if lse else 0)
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
    and dV accumulated) at the peak of q's dtype (f32: the CUDA cores; bf16:
    the tensor cores) vs the bytes of q, k, v, o, dO, the f32 lse and the
    mask read and dQ, dK, dV written once each."""
    b, t, h, d = q.shape
    lens = mask.sum(1).double()
    pairs = float((lens ** 2 + (t - lens) ** 2).sum())
    ops_ms = 10.0 * h * d * pairs / PEAK_FLOPS[q.dtype] * 1e3
    nbytes = 8 * q.numel() * q.element_size() + b * h * t * 4 + mask.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
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
    """Counts the forward kernel's launches by (dtype, T, with lse) while active,
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
            self.counts[f"{dtype_name(q.dtype)}_T{q.shape[1]}" + ("_lse" if with_lse else "")] += 1
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
        rows.append(host_tensor(emb).cuda().float())
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
    exact = run_matches_exact(parse_trec_run(trec), qids, torch.from_numpy(q_embs).cuda(),
                              rows, offs + 1000)
    log(f"  run vs exact plain search: top-{TOP_N} sets equal for {exact}/{len(qids)} "
        "queries, near-ties at the cut otherwise")
    return qids, q_embs


def run_matches_exact(run, qids, q, rows, row_pids):
    """Holds each query's top-``TOP_N`` pids of a TREC run to an exact
    plain-PyTorch search (one f32 matmul over ``rows``, a stable sort):
    equal sets, or differences only in near-ties at the k-th score, within
    1e-5*|q|*max|p|. Returns the count of queries whose sets are equal."""
    scores = q @ rows.T
    top_s, top_i = stable_topk(scores, TOP_N)
    ref_pids = row_pids[top_i].cpu().numpy()
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
            s = scores[r, int(torch.nonzero(row_pids == pid)[0])].item()
            if abs(s - kth) > tol:
                raise AssertionError(f"{qid}: run differs from the exact search")
    return exact


def ranks_match(run, ref, qids, q, rows, row_pids):
    """Holds a TREC run to a reference run rank by rank: at each of a
    query's ``TOP_N`` ranks the two pids are equal or their exact f32
    scores (one matmul over ``rows``) lie within 1e-5*|q|*max|p|, so the
    runs differ only in the order of near-ties. Returns the count of
    queries whose ranked pids are equal and the largest score gap at a
    differing rank, as a share of its tolerance."""
    order = torch.argsort(row_pids)
    sorted_pids = row_pids[order]
    pmax = rows.norm(dim=1).max().item()
    equal, gap = 0, 0.0
    for r, qid in enumerate(qids):
        got = [pid for pid, _ in run[qid]]
        want = [pid for pid, _ in ref[qid]]
        if got == want:
            equal += 1
            continue
        if len(got) != len(want):
            raise AssertionError(f"{qid}: {len(got)} pids against {len(want)}")
        pids = torch.tensor([got, want], device=rows.device)
        scores = rows[order[torch.searchsorted(sorted_pids, pids)]] @ q[r]  # [2, TOP_N]
        worst = (scores[0] - scores[1]).abs().max().item() / (1e-5 * q[r].norm().item() * pmax)
        if worst > 1.0:
            raise AssertionError(f"{qid}: the runs differ beyond near-ties ({worst} x tol)")
        gap = max(gap, worst)
    return equal, gap


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


def library_attention(q, k, v, mask):
    """Masked SDPA in the port's [B, T, H, D] layout, differentiable: a
    third f32 attention, the train-step check's second witness."""
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), attn_mask=allowed).transpose(1, 2)


def check_train_step():
    """One full-width KD + ranking step at the port's init, four times on
    one batch: attention through the kernels, the plain version and
    masked SDPA (all f32), and the plain step with every operation in
    f64, the witness of the exact gradient. Each f32 loss within 1e-5
    relative of the f64 one. A gradient's reading is its largest
    difference from the f64 gradient over the latter's largest entry (the
    key biases' gradient is zero in exact arithmetic, softmax shift
    invariance, so theirs is over their layer's key-weight gradient's).
    Query and key parameters are ill-conditioned the same way: their
    exact gradient is a small difference of large terms (each row of the
    score gradient sums to zero), more so with depth as token states grow
    alike, and every f32 attention reads up to ~3e-3 there. So each f32
    version's readings over 1e-4 must be query or key parameters, and
    each of the kernels' readings must be within 1e-4 or within the
    larger of the plain and SDPA readings of that gradient: the kernels
    round no worse than the other f32 attentions."""
    device = torch.device("cuda")
    student, teacher = (load_model_and_params("rdot_nll", "init", device=device, seed=seed)[2]
                        for seed in (42, 0))
    teacher.requires_grad_(False)
    init = {n: p.detach().clone() for n, p in student.state_dict().items()}
    batch = train_step_batch(np.random.default_rng(2))
    config = TrainConfig(ranking_task=True, num_negatives=TRAIN_NEG)
    results = {}
    for name, attn, dtype in (("kernels", flash_attention, torch.float32),
                              ("plain", plain_attention, torch.float32),
                              ("sdpa", library_attention, torch.float32),
                              ("f64", flash_attention_plain, torch.float64)):
        transformer.flash_attention = attn
        try:
            student.to(dtype)
            teacher.to(dtype)
            student.load_state_dict(init)
            state, tx = create_train_state(student, config, 10)
            _, metrics = make_train_step(student, teacher, tx, config)(state, batch)
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = flash_attention
        results[name] = (float(metrics["loss"]),
                         {n: p.grad.detach().double() for n, p in student.named_parameters()})
        del state, tx
    student.float()
    teacher.float()
    loss_x, g_x = results.pop("f64")
    losses = {side: loss for side, (loss, _) in results.items()}
    for side, loss in losses.items():
        if not abs(loss - loss_x) <= 1e-5 * abs(loss_x):
            raise AssertionError(f"train step loss: {side} {loss} vs f64 {loss_x}")
    readings, apart = {}, {}  # apart: kernels vs plain, for the record
    for n, ref in g_x.items():
        scale_of = n.replace("key.bias", "key.weight") if n.endswith("key.bias") else n
        scale = g_x[scale_of].abs().max().item()
        readings[n] = {side: (g[n] - ref).abs().max().item() / scale
                       for side, (_, g) in results.items()}
        apart[n] = (results["kernels"][1][n] - results["plain"][1][n]).abs().max().item() / scale
    for n, r in readings.items():
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"train step gradient {n}: {r}")
        over = [side for side, v in r.items() if v > 1e-4]
        if over and not re.search(r"attention\.self\.(query|key)\.", n):
            raise AssertionError(f"train step gradient {n}: {over} over 1e-4 of scale vs f64 "
                                 f"outside the query and key parameters: {r}")
        if not r["kernels"] <= max(1e-4, r["plain"], r["sdpa"]):
            raise AssertionError(f"train step gradient {n}: the kernels {r['kernels']:.3e} of "
                                 f"scale from f64, over 1e-4, plain {r['plain']:.3e} and SDPA "
                                 f"{r['sdpa']:.3e}")
    worst = {side: max((r[side], n) for n, r in readings.items()) for side in losses}
    ratio, ratio_leaf = max((r["kernels"] / max(1e-4, r["plain"], r["sdpa"]), n)
                            for n, r in readings.items())
    apart_worst = max((v, n) for n, v in apart.items())
    short = lambda n: n.replace("roberta.encoder.", "")  # noqa: E731
    log(f"  full-width train step at the port's init, against the f64 step: loss "
        + ", ".join(f"{side} {loss:.7f}" for side, loss in losses.items())
        + f", f64 {loss_x:.7f}; {len(g_x)} gradients, worst "
        + "; ".join(f"{side} {v:.3e} of scale ({short(n)})" for side, (v, n) in worst.items())
        + "; over 1e-4: " + ", ".join(
            f"{side} {sum(r[side] > 1e-4 for r in readings.values())}" for side in losses)
        + f" (query/key only); kernels / max(1e-4, plain, SDPA) at most {ratio:.2f} "
        f"({short(ratio_leaf)}), ok; kernels vs plain at most {apart_worst[0]:.3e} of scale "
        f"({short(apart_worst[1])})")
    del results, g_x
    student.load_state_dict(init)
    phases = time_step_phases(student, teacher, batch, config)
    del student, teacher, init
    torch.cuda.empty_cache()
    over = {n: r for n, r in readings.items() if max(r.values()) > 1e-4}
    return {"loss": {**losses, "f64": loss_x},
            "worst_grad_rel_vs_f64": {side: {"rel": v, "leaf": n} for side, (v, n) in worst.items()},
            "kernels_over_max_witness": {"ratio": ratio, "leaf": ratio_leaf},
            "kernels_vs_plain": {"rel": apart_worst[0], "leaf": apart_worst[1]},
            "readings_over_1e-4": over, "phases_ms": phases}


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


def step_times(metrics_path, save_steps):
    """Steady-state ms per step from metrics.jsonl's wall times: intervals
    after step 2, leaving out those that hold a checkpoint write."""
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    times = {r["step"]: r["time"] for r in rows}
    gaps = [times[s] - times[s - 1] for s in range(3, len(rows) + 1)
            if (s - 1) % save_steps != 0]
    return rows, 1e3 * float(np.mean(gaps))


def train_path(dtype="float32"):
    """run_convdr_train.main at full width in ``dtype``; counts zeroed just
    before and read just after; then the output dir reloads (for inference
    in ``dtype``) and encodes a fixed batch exactly as the trained in-memory
    student does."""
    work = os.path.join(WORK, f"train_{dtype}")
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
        "--max_steps", str(TRAIN_STEPS), "--save_steps", str(save_steps), "--dtype", dtype,
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
    # the driver's GELU for the dtype (tanh under bf16), as the inference
    # driver's --gelu auto picks it
    _, tok, reloaded = load_model_and_params("rdot_nll", out_dir, device=torch.device("cuda"),
                                             dtype=getattr(torch, dtype),
                                             arch_overrides=gelu_arch_overrides("auto", dtype))
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(3, len(tok), (TRAIN_B, TRAIN_T), generator=gen, device="cuda")
    mask = (torch.arange(TRAIN_T, device="cuda")[None, :]
            < torch.tensor([[256], [100], [17], [3]], device="cuda")).int()
    trained[out_dir].eval()
    with torch.no_grad():
        same = torch.equal(reloaded.query_emb(ids, mask), trained[out_dir].query_emb(ids, mask))
    if not same:
        raise AssertionError("the reloaded model encodes differently from the trained one")
    log(f"  training {dtype} ms/step {ms_step:.1f} (steady state after step 2, checkpoint writes "
        f"left out), {1e3 * TRAIN_B / ms_step:.1f} examples/s; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; reloaded model encodes identically")
    return launches, {"ms_per_step": ms_step, "examples_per_s": 1e3 * TRAIN_B / ms_step,
                      "train_s": t_train, "losses": losses}


# ---------------------------------------------------------------------------
# phase 4f: bf16 training (kernel 1 with its lse and kernel 1b in bf16, f32
# master weights), then dropout
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16
BF16_LSE_SHAPES = [(TRAIN_B, TRAIN_T), (TRAIN_B, TARGET_T), (5, 200)]


def check_bf16_forward_lse(gen):
    """Kernel 1 in bf16 with lse at the student's shapes under every mask
    kind: lse within 1e-5 relative of the plain log-sum-exp (f32 scores of
    the bf16 operands), and out bit-identical to the launch without lse
    (which inference and serving make). Returns the worst out error against
    the plain forward (one bf16 ulp allowed, as check_attention) and the
    worst lse error by shape."""
    worst = {}
    for batch, t in BF16_LSE_SHAPES:
        for kind in MASK_KINDS:
            q, k, v, mask = attention_inputs(batch, t, BF16, gen, kind)
            out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
            bare, _ = flash_attention_fwd(q, k, v, mask, with_lse=False)
            torch.cuda.synchronize()
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / HEAD_DIM ** 0.5
            allowed = mask[:, None, :, None] == mask[:, None, None, :]
            want = torch.logsumexp(scores.masked_fill(~allowed, float("-inf")), dim=-1)
            lse_rel = ((lse - want).abs() / want.abs()).max().item()
            ref = flash_attention_plain(q, k, v, mask).float()
            diff = (out.float() - ref).abs()
            same = torch.equal(out, bare)
            ok = (same and lse_rel <= 1e-5 and bool(torch.isfinite(lse).all())
                  and bool((diff <= 1e-6 + 2.0 ** -7 * ref.abs()).all()))
            log(f"  attention bf16 with lse B={batch} T={t} {kind}: lse max rel err "
                f"{lse_rel:.2e} (tol 1e-5), out bit-identical to no-lse {same}, out max_abs_err "
                f"{diff.max().item():.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"bf16 forward with lse at B={batch} T={t} {kind}")
            worst[(batch, t, kind)] = (diff.max().item(), lse_rel)
    return worst


def bf16_bwd_readings(q, k, v, mask, do):
    """Each gradient's largest error over its largest entry, against the
    plain backward in f64 of the same bf16 operands: the kernel's and
    autograd's through masked SDPA in bf16; plus the kernel's gradients."""
    out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, mask, lse)
    x = [t.double() for t in (q, k, v, do)]
    want = flash_attention_bwd_plain(x[0], x[1], x[2], None, x[3], mask)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
    lib = [g.transpose(1, 2) for g in torch.autograd.grad(lib_out, leaves, do.transpose(1, 2))]
    torch.cuda.synchronize()
    rel = lambda g, w: ((g.double() - w).abs().max() / w.abs().max()).item()  # noqa: E731
    return got, [rel(g, w) for g, w in zip(got, want)], [rel(g, w) for g, w in zip(lib, want)]


def check_bf16_attention_bwd(gen):
    """Kernel 1b in bf16 at the training shapes under every mask kind: each
    gradient within 2x the error of autograd through masked SDPA in bf16
    (floor 1e-3 of scale) from the f64 plain witness, and two calls on the
    same inputs bit-identical (no atomics); at each shape its D pre-pass
    against the f32 sum of the same products."""
    worst = {}
    for batch, t in BWD_SHAPES:
        for kind in MASK_KINDS:
            q, k, v, mask = attention_inputs(batch, t, BF16, gen, kind)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(BF16)
            got, kern, lib = bf16_bwd_readings(q, k, v, mask, do)
            out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
            again = flash_attention_bwd(q, k, v, out, do, mask, lse)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ok = same and finite and all(ke <= 2 * max(le, 1e-3) for ke, le in zip(kern, lib))
            log(f"  attention bwd bf16 B={batch} T={t} {kind}: dQ/dK/dV error of scale vs f64 "
                f"kernel {kern[0]:.2e}/{kern[1]:.2e}/{kern[2]:.2e}, SDPA {lib[0]:.2e}/"
                f"{lib[1]:.2e}/{lib[2]:.2e} (tol 2x SDPA, floor 1e-3); two calls "
                f"bit-identical {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"bf16 attention backward at B={batch} T={t} {kind}")
            worst[(batch, t, kind)] = {"kernel": kern, "sdpa": lib}
        # the pre-pass D = rowsum(o * dO) against the f32 sum of the same
        # products: within 1e-5 of each row's sum of |o * dO| (another order)
        out, _lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
        delta = flash_attention_bwd_delta(out, do)
        prod = out.float() * do.float()
        slack = ((delta - prod.sum(-1).transpose(1, 2)).abs()
                 / prod.abs().sum(-1).transpose(1, 2).clamp_min(1e-30)).max().item()
        log(f"  attention bwd bf16 B={batch} T={t}: pre-pass D max error {slack:.2e} of the "
            f"row's sum of |o dO| (tol 1e-5) {'ok' if slack <= 1e-5 else 'FAIL'}")
        if slack > 1e-5:
            raise AssertionError(f"bf16 backward pre-pass at B={batch} T={t}")
    return worst


def time_bf16_attention(gen, fwd_worst, bwd_worst):
    """The two bf16 training kernels timed at the student's shape (and the
    backward at the teacher documents' B=40 T=512 too): host-paced and on
    the device, beside the plain version, the library (masked SDPA in bf16:
    its forward; autograd's backward) and the bound at the bf16 peaks."""
    q, k, v, mask = attention_inputs(TRAIN_B, TRAIN_T, BF16, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    kernel = lambda: flash_attention_fwd(q, k, v, mask, with_lse=True)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)  # noqa: E731
    bound_ms, bound_by = attention_bound_ms(q, mask, lse=True)
    fwd = {
        "name": "flash_attention_fwd_bf16_lse",
        "route": "cuda",
        "source": "convdr_torch/csrc/flash_attention.cu",
        "replaces": "convdr_tpu/models/attention.py:54 (Pallas TPU flash forward with "
                    "residuals, pallas_call at jax/experimental/pallas/ops/tpu/"
                    "flash_attention.py:758)",
        "launches": 0,
        "max_abs_err": fwd_worst[(TRAIN_B, TRAIN_T, "right")][0],
        "lse_max_rel_err": max(v[1] for v in fwd_worst.values()),
        "ms": cuda_ms(kernel, iters=50), "device_ms": device_ms(kernel, iters=50),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, mask), iters=5),
        "library_ms": cuda_ms(library, iters=50), "library_device_ms": device_ms(library, iters=50),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": f"B={TRAIN_B} T={TRAIN_T} H={HEADS} D={HEAD_DIM} bf16, with lse",
        "config": flash_attention_fwd_config(TRAIN_B, TRAIN_T, HEADS, HEAD_DIM, BF16),
    }
    shapes = {}
    for batch, t in ((TRAIN_B, TRAIN_T), (TRAIN_B * (TRAIN_NEG + 1), DOC_T)):
        q, k, v, mask = attention_inputs(batch, t, BF16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(BF16)
        out, lse = flash_attention_fwd(q, k, v, mask, with_lse=True)
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        allowed = mask[:, None, :, None] == mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        dot = do.transpose(1, 2)
        kernel = lambda: flash_attention_bwd(q, k, v, out, do, mask, lse)  # noqa: E731
        library = lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True)  # noqa: E731
        bound_ms, bound_by = attention_bwd_bound_ms(q, mask)
        shapes[f"B{batch}xT{t}"] = {
            "ms": cuda_ms(kernel, iters=50), "device_ms": device_ms(kernel, iters=50),
            "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, mask), iters=3),
            "library_ms": cuda_ms(library, iters=50),
            "library_device_ms": device_ms(library, iters=50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "config": flash_attention_bwd_config(batch, t, HEADS, HEAD_DIM, BF16),
            "error_of_scale_vs_f64": bwd_worst[(batch, t, "right")],
        }
        cfg = shapes[f"B{batch}xT{t}"]["config"]
        blocks = 2 * -(-t // cfg["block_rows"]) * HEADS * batch
        shapes[f"B{batch}xT{t}"]["waves"] = blocks / (
            cfg["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count)
    main = shapes[f"B{TRAIN_B}xT{TRAIN_T}"]
    bwd = {
        "name": "flash_attention_bwd_bf16",
        "route": "cuda",
        "source": "convdr_torch/csrc/flash_attention_bwd.cu",
        "replaces": "convdr_tpu/models/attention.py:54 (custom VJP in bf16: pallas_call "
                    "_flash_attention_bwd_dkv and _flash_attention_bwd_dq)",
        "launches": 0,
        "max_abs_err": max(main["error_of_scale_vs_f64"]["kernel"]),
        **{key: main[key] for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                      "library_device_ms", "bound_ms", "bound_by", "config")},
        "shape": f"B={TRAIN_B} T={TRAIN_T} H={HEADS} D={HEAD_DIM} bf16",
        "waves": main["waves"],
        "by_shape": shapes,
    }
    log("  bf16 training kernels (ms host-paced / on the device; plain; SDPA host-paced / "
        "device; bound): forward with lse B4xT256 "
        f"{fwd['ms']:.4f} / {fwd['device_ms']:.4f}; {fwd['plain_ms']:.4f}; "
        f"{fwd['library_ms']:.4f} / {fwd['library_device_ms']:.4f}; {fwd['bound_ms']:.4f} "
        f"({fwd['bound_by']}); " + "; ".join(
            f"backward {name} {r['ms']:.4f} / {r['device_ms']:.4f}; {r['plain_ms']:.4f}; "
            f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f}; {r['bound_ms']:.4f} "
            f"({r['bound_by']}), {r['waves']:.2f} waves" for name, r in shapes.items()))
    return fwd, bwd


def check_train_step_bf16():
    """One full-width KD + ranking step in bf16 at the port's init (student:
    f32 masters cast at use; teacher: cast to bf16), with attention through
    the kernels, the plain version and masked SDPA, each held to the plain
    step run wholly in f64. Readings as check_train_step's (a loss's
    relative error; a gradient's largest error over its largest entry, the
    key biases' over their key weights'); the kernels' loss and every
    gradient reading no worse than 2x the larger of the plain and SDPA
    readings. Then the step's parts timed (CUDA events)."""
    device = torch.device("cuda")
    student = load_model_and_params("rdot_nll", "init", device=device, dtype=BF16,
                                    f32_params=True, seed=42)[2]
    teacher = load_model_and_params("rdot_nll", "init", device=device, dtype=BF16, seed=0)[2]
    teacher.requires_grad_(False)
    init = {n: p.detach().clone() for n, p in student.state_dict().items()}
    batch = train_step_batch(np.random.default_rng(2))
    config = TrainConfig(ranking_task=True, num_negatives=TRAIN_NEG)
    results = {}
    for name, attn in (("kernels", flash_attention), ("plain", plain_attention),
                       ("sdpa", library_attention), ("f64", flash_attention_plain)):
        transformer.flash_attention = attn
        try:
            if name == "f64":
                del student, teacher
                torch.cuda.empty_cache()
                student, teacher = (load_model_and_params("rdot_nll", "init", device=device,
                                                          seed=seed)[2].double()
                                    for seed in (42, 0))
                teacher.requires_grad_(False)
            student.load_state_dict(init)
            state, tx = create_train_state(student, config, 10)
            _, metrics = make_train_step(student, teacher, tx, config)(state, batch)
            torch.cuda.synchronize()
        finally:
            transformer.flash_attention = flash_attention
        results[name] = (float(metrics["loss"]),
                         {n: p.grad.detach().double() for n, p in student.named_parameters()})
        if name != "f64" and not all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                                     for p in student.parameters()):
            raise AssertionError(f"bf16 train step ({name}): parameters or gradients not f32")
        del state, tx
    del student, teacher
    torch.cuda.empty_cache()
    loss_x, g_x = results.pop("f64")
    loss_reading = {side: abs(loss - loss_x) / abs(loss_x) for side, (loss, _) in results.items()}
    readings = {}
    for n, ref in g_x.items():
        scale_of = n.replace("key.bias", "key.weight") if n.endswith("key.bias") else n
        scale = g_x[scale_of].abs().max().item()
        readings[n] = {side: (g[n] - ref).abs().max().item() / scale
                       for side, (_, g) in results.items()}
    witness = lambda r: max(r["plain"], r["sdpa"])  # noqa: E731
    if not loss_reading["kernels"] <= 2 * witness(loss_reading):
        raise AssertionError(f"bf16 train step loss readings {loss_reading}")
    for n, r in readings.items():
        if not all(np.isfinite(v) for v in r.values()) or not r["kernels"] <= 2 * witness(r):
            raise AssertionError(f"bf16 train step gradient {n}: {r}")
    ratio, leaf = max((r["kernels"] / witness(r), n) for n, r in readings.items())
    worst = {side: max((r[side], n) for n, r in readings.items()) for side in loss_reading}
    short = lambda n: n.replace("roberta.encoder.", "")  # noqa: E731
    log("  full-width bf16 train step at the port's init, against the f64 step: loss "
        + ", ".join(f"{side} {results[side][0]:.6f} (rel {v:.2e})"
                    for side, v in loss_reading.items())
        + f", f64 {loss_x:.6f}; {len(g_x)} gradients (f32), worst "
        + "; ".join(f"{side} {v:.3e} of scale ({short(n)})" for side, (v, n) in worst.items())
        + f"; kernels / max(plain, SDPA) at most {ratio:.2f} ({short(leaf)}), tol 2, ok")
    del results, g_x
    student = load_model_and_params("rdot_nll", "init", device=device, dtype=BF16,
                                    f32_params=True, seed=42)[2]
    teacher = load_model_and_params("rdot_nll", "init", device=device, dtype=BF16, seed=0)[2]
    teacher.requires_grad_(False)
    phases = time_step_phases(student, teacher, batch, config)
    del student, teacher, init
    torch.cuda.empty_cache()
    return {"loss_rel_vs_f64": loss_reading,
            "worst_grad_rel_vs_f64": {side: {"rel": v, "leaf": n} for side, (v, n) in worst.items()},
            "kernels_over_max_witness": {"ratio": ratio, "leaf": leaf}, "phases_ms": phases}


def dropout_path():
    """run_convdr_train.main --use_dropout for 4 steps at full width, twice
    with one seed: finite losses, the teacher's forwards through kernel 1,
    the same losses from the same seed."""
    runs = []
    for i in range(2):
        work = os.path.join(WORK, f"dropout_{i}")
        os.makedirs(work)
        make_train_file(os.path.join(work, "train.jsonl"))
        flash_attention.launches = 0
        flash_attention_bwd.launches = 0
        t0 = time.time()
        run_convdr_train.main([
            "--output_dir", os.path.join(work, "model"),
            "--train_file", os.path.join(work, "train.jsonl"), "--model_type", "rdot_nll",
            "--model_name_or_path", "init", "--query", "no_res", "--ranking_task",
            "--num_negatives", str(TRAIN_NEG), "--per_gpu_train_batch_size", str(TRAIN_B),
            "--max_concat_length", str(TRAIN_T), "--max_doc_length", str(DOC_T),
            "--learning_rate", "1e-5", "--max_steps", "4", "--use_dropout"])
        torch.cuda.synchronize()
        with open(os.path.join(work, "model", "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        runs.append({"losses": losses, "seconds": time.time() - t0,
                     "launches": {"flash_attention_fwd": flash_attention.launches,
                                  "flash_attention_bwd": flash_attention_bwd.launches}})
        shutil.rmtree(work)
    a, b = runs
    ok = (len(a["losses"]) == 4 and all(np.isfinite(a["losses"]))
          and a["launches"]["flash_attention_fwd"] > 0 and a["losses"] == b["losses"])
    log(f"  run_convdr_train --use_dropout, 4 steps, twice: losses {a['losses']} / "
        f"{b['losses']} (same seed: equal {a['losses'] == b['losses']}); launches "
        f"{a['launches']} (the student's attention is the plain einsum under dropout, the "
        f"teacher's through kernel 1); {a['seconds']:.1f} / {b['seconds']:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"dropout training: {runs}")
    return runs


def bf16_training_path(gen):
    """Phase 4f: the bf16 kernels against their plain versions and timed,
    one full-width bf16 step against the f64 step, the bf16 training driver
    (counts zeroed before, read after), then the dropout driver runs."""
    t_phase = time.time()
    fwd_worst = check_bf16_forward_lse(gen)
    bwd_worst = check_bf16_attention_bwd(gen)
    fwd, bwd = time_bf16_attention(gen, fwd_worst, bwd_worst)
    torch.cuda.empty_cache()
    step_check = check_train_step_bf16()
    launches, train = train_path("bfloat16")
    if launches["flash_attention_bwd"] <= 0:
        raise AssertionError(f"bf16 training launched no backward: {launches}")
    fwd["launches"] = launches["flash_attention_fwd_by_shape"].get(f"bfloat16_T{TRAIN_T}_lse", 0)
    bwd["launches"] = launches["flash_attention_bwd"]
    torch.cuda.empty_cache()
    dropout = dropout_path()
    return {"kernels": [fwd, bwd], "launches": launches, "train": train,
            "train_step_check": step_check, "dropout": dropout,
            "phase_s": time.time() - t_phase}


# ---------------------------------------------------------------------------
# the data plane: raw text -> token cache -> bf16 .cnb blocks -> traced search
# ---------------------------------------------------------------------------
DP_WORKERS, DP_MAX_WORDS = 8, 110
DP_WORDS = ("ocean coral reef tide whale harbor glacier summit valley granite "
            "engine turbine piston throttle violin sonata melody chord neuron "
            "synapse cortex senate ballot statute verdict harvest orchard "
            "drought galaxy nebula photon orbit protein enzyme membrane ledger "
            "equity dividend margin").split()

# runs the tokenize driver's main in a fresh interpreter whose __main__ is
# this code string, so the spawned workers import only the driver's
# torch-free chain; the merge is wrapped so that the plain merge runs on
# the same split files and must give the same cache and pids
TOKENIZE_CODE = r"""
import json, os, sys, time
from convdr_torch import native_io
from convdr_torch.data import tokenize_pipeline
from convdr_torch.drivers import tokenize_collection

def merge_both(splits, out_path, record_bytes, max_records):
    t0 = time.time()
    pids = native_io.merge_token_splits(splits, out_path, record_bytes, max_records)
    t_native = time.time() - t0
    t0 = time.time()
    plain = native_io.merge_token_splits_plain(splits, out_path + ".plain", record_bytes,
                                               max_records)
    t_plain = time.time() - t0
    with open(out_path, "rb") as a, open(out_path + ".plain", "rb") as b:
        same = a.read() == b.read() and pids.tolist() == plain.tolist()
    os.remove(out_path + ".plain")
    print("MERGE " + json.dumps({"identical": same, "records": int(len(pids)),
                                 "native_s": t_native, "plain_s": t_plain}), flush=True)
    return pids

t0 = time.time()
native_io.load()  # the host library's g++ build at first use, timed apart
build_s = time.time() - t0
tokenize_pipeline.merge_token_splits = merge_both
t0 = time.time()
count = tokenize_collection.main(sys.argv[1:])
print("TOKENIZE " + json.dumps({"passages": count, "seconds": time.time() - t0,
                                "native_available": native_io.native_available(),
                                "native_build_s": build_s}))
"""


def write_collection(path):
    """``N_PASSAGES`` passages of 4-110 words from a fixed list, pids 1000 +
    line (the pids the main path's qrels name); with the tiny vocabulary's
    about one token a character, the longer ones pass the 512-token cap."""
    rng = np.random.default_rng(11)
    with open(path, "w") as f:
        for i in range(N_PASSAGES):
            words = rng.choice(DP_WORDS, int(rng.integers(4, DP_MAX_WORDS + 1)))
            f.write(f"{1000 + i}\t{' '.join(words)}\n")


def tokenize_cli(collection, processed, queries=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    argv = ["--collection", collection, "--out_data_dir", processed,
            "--model_type", "rdot_nll", "--max_seq_length", "512",
            "--num_workers", str(DP_WORKERS)] + (["--queries", queries] if queries else [])
    proc = subprocess.run([sys.executable, "-c", TOKENIZE_CODE, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"tokenize driver failed:\n{proc.stdout}\n{proc.stderr}")
    out = {}
    for line in proc.stdout.splitlines():
        for tag in ("MERGE", "TOKENIZE"):
            if line.startswith(tag + " "):
                out[tag.lower()] = json.loads(line[len(tag) + 1:])
    return out


def trace_summary(trace_dir):
    """The search phase's CUDA kernels from the ``--profile_dir`` trace:
    launches and device ms by kernel name, and the device-busy share, the
    union of kernel intervals over the span's wall time (copies apart)."""
    (name,) = [n for n in os.listdir(trace_dir) if n.endswith(".json")]
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == TRACE_SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise AssertionError(f"trace {name}: {len(spans)} '{TRACE_SPAN}' spans")
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    intervals, copy_us = [], 0.0
    for e in events:
        if e.get("ph") != "X" or not lo <= e.get("ts", -1) <= hi:
            continue
        if e.get("cat") == "kernel":
            short = e["name"].replace("(anonymous namespace)::", "")
            short = re.split(r"[(<]", short.removeprefix("void "))[0][:80]
            by_name[short][0] += 1
            by_name[short][1] += e["dur"] / 1e3
            intervals.append((e["ts"], min(hi, e["ts"] + e["dur"])))
        elif e.get("cat") == "gpu_memcpy":
            copy_us += e["dur"]
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"span_ms": (hi - lo) / 1e3, "kernel_launches": sum(v[0] for v in by_name.values()),
            "device_busy_share": busy / (hi - lo) if intervals else None,
            "memcpy_ms": copy_us / 1e3,
            "by_kernel": {k: {"launches": v[0], "ms": v[1]}
                          for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])}}


def data_plane_path(paths, qids, q_embs):
    """A raw collection through the port's data plane at full width: the
    tokenize driver (8 workers, the native merge held to the plain one),
    ``gen_passage_embeddings`` writing bf16 ``.cnb`` blocks, and a traced
    ``run_convdr_inference`` over them with bf16 storage, whose run is held
    to an exact plain search of the same bf16 rows. The kernels' counts are
    zeroed before the embed and read after the search."""
    work = os.path.join(WORK, "data_plane")
    raw, processed = paths["raw"], os.path.join(work, "processed")
    emb_dir, trace_dir = os.path.join(work, "embeddings"), os.path.join(work, "trace")
    os.makedirs(work)
    collection = os.path.join(work, "collection.tsv")
    write_collection(collection)
    tok = tokenize_cli(collection, processed, os.path.join(raw, "queries.raw.tsv"))
    merge, res = tok["merge"], tok["tokenize"]
    lens = TokenCache(os.path.join(processed, "passages")).slice(0, N_PASSAGES)[1]
    if (res["passages"] != N_PASSAGES or not merge["identical"]
            or not res["native_available"] or lens.max() != 512):
        raise AssertionError(f"tokenize: {tok}, longest record {lens.max()}")
    n_queries = len(TokenCache(os.path.join(processed, "queries.raw")))
    log(f"  tokenize driver, {DP_WORKERS} workers: {N_PASSAGES} passages in "
        f"{res['seconds']:.2f} s ({N_PASSAGES / res['seconds']:.0f} passages/s; "
        f"{int((lens == 512).sum())} reach the 512-token cap), {n_queries} queries; "
        f"native_available() {res['native_available']} (g++ build at first use "
        f"{res['native_build_s']:.2f} s, before the timed run); native merge "
        f"{merge['native_s'] * 1e3:.1f} ms, plain merge {merge['plain_s'] * 1e3:.1f} ms, "
        f"byte-identical cache and pids: {merge['identical']}")
    if n_queries != N_TOPICS * N_TURNS:
        raise AssertionError(f"query cache holds {n_queries} queries")

    flash_attention.launches = 0
    fused_scores_groupmax.launches = 0
    dma_gather_groups.launches = 0
    t0 = time.time()
    rows = gen_passage_embeddings.main([
        "--data_dir", processed, "--checkpoint", "init", "--model_type", "rdot_nll",
        "--output_dir", emb_dir, "--per_gpu_eval_batch_size", "64", "--dtype", "bfloat16",
        "--storage_dtype", "bfloat16", "--block_format", "native",
    ])
    t_embed = time.time() - t0
    cnb = os.path.join(emb_dir, "passage_block_0.cnb")
    cnb_bytes = os.path.getsize(cnb)
    want_bytes = 32 + N_PASSAGES * SEARCH_D * 2 + N_PASSAGES * 8
    if rows != N_PASSAGES or os.listdir(emb_dir) != ["passage_block_0.cnb"] \
            or cnb_bytes != want_bytes:
        raise AssertionError(f"bf16 .cnb blocks: {os.listdir(emb_dir)}, {cnb_bytes} bytes")
    log(f"  embedded {rows} passages (bf16 compute, bf16 .cnb block) in {t_embed:.2f} s; "
        f"{cnb_bytes} bytes = 32 header + {N_PASSAGES}x{SEARCH_D}x2 rows + "
        f"{N_PASSAGES}x8 ids (f32 rows would take {N_PASSAGES * SEARCH_D * 4})")
    t0 = time.time()
    metrics = run_convdr_inference.main(
        inference_argv(WORK, processed, raw, emb_dir, "run_dp")
        + ["--storage_dtype", "bfloat16", "--profile_dir", trace_dir])
    torch.cuda.synchronize()
    t_infer = time.time() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"data plane did not run through its kernels: {launches}")
    for name, value in metrics.items():
        if not 0.0 <= value <= 1.0:
            raise AssertionError(f"metric {name}={value} out of range")

    emb, offs = load_rows(emb_dir)
    blk = next(iter_embedding_blocks(emb_dir))[1]
    if str(blk.dtype) != "bfloat16" or not torch.isfinite(emb).all():
        raise AssertionError(f"the .cnb block holds {blk.dtype} rows")
    offset2pid = torch.tensor(load_offset2pid(processed), device="cuda")
    q = torch.from_numpy(q_embs).cuda()
    exact = run_matches_exact(parse_trec_run(os.path.join(WORK, "run_dp.trec")), qids, q,
                              emb, offset2pid[offs])
    log(f"  inference + search (bf16 storage, traced) in {t_infer:.2f} s; launches "
        f"{launches}; run vs exact plain search of the same bf16 rows: top-{TOP_N} sets "
        f"equal for {exact}/{len(qids)} queries, near-ties at the cut otherwise")

    # the score kernel at this path's shape, against its plain version
    p = host_tensor(blk).cuda()
    p = torch.cat([p, p.new_zeros(-len(p) % ROW_TILE, SEARCH_D)])
    s, _g = fused_scores_groupmax(q, p, GROUP)
    s_ref, _g_ref = fused_scores_groupmax_plain(q, p, GROUP)
    pnorm_max = p.float().norm(dim=1).max().item()
    err = (s - s_ref).abs()
    if not bool((err <= 1e-5 * q.norm(dim=1)[:, None] * pnorm_max).all()):
        raise AssertionError(f"scores at the data plane's shape: {err.max().item()}")
    trace = trace_summary(trace_dir)
    share = trace["device_busy_share"]
    log(f"  search phase trace: span {trace['span_ms']:.1f} ms, "
        f"{trace['kernel_launches']} kernel launches, device busy "
        f"{'not measured (no CUDA kernels in the trace)' if share is None else f'{share:.4f}'}"
        f" of the span, copies {trace['memcpy_ms']:.2f} ms; by kernel "
        + ", ".join(f"{k} {v['launches']}x {v['ms']:.3f} ms"
                    for k, v in list(trace["by_kernel"].items())[:12]))
    return {"launches": launches, "tokenize": tok, "embed_s": t_embed,
            "inference_s": t_infer, "cnb_bytes": cnb_bytes, "metrics": metrics,
            "exact_queries": exact, "score_err_at_shape": err.max().item(), "trace": trace}


# ---------------------------------------------------------------------------
# phase O: the JAX package's orbax checkpoints (OCDBT + zarr v2, zstd)
# ---------------------------------------------------------------------------
ORBAX_FIXTURE = os.path.join(REPO, "tests", "fixtures_torch", "jax_orbax_tiny")


class DecoderClock:
    """Sums the seconds and decoded bytes of every chunk decode
    (``native_io.zstd_decompress``, which the zarr layer calls) while
    active."""

    def __enter__(self):
        self.seconds, self.nbytes, self.frames, self.largest = 0.0, 0, 0, 0
        self.real = native_io.zstd_decompress

        def timed(frame, out=None, size=None):
            t0 = time.perf_counter()
            got = self.real(frame, out=out, size=size)
            self.seconds += time.perf_counter() - t0
            self.nbytes += got.nbytes
            self.frames += 1
            self.largest = max(self.largest, len(frame))
            return got

        native_io.zstd_decompress = timed
        return self

    def __exit__(self, *exc):
        native_io.zstd_decompress = self.real

    def summary(self):
        return {"decoded_bytes": self.nbytes, "decoder_s": self.seconds, "frames": self.frames,
                "largest_frame_bytes": self.largest,
                "decoder_MBps": self.nbytes / max(self.seconds, 1e-9) / 1e6}


class PeakRss:
    """The process's peak resident set while active, sampled every 5 ms
    from /proc/self/statm."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self.rss()
        self.stop = threading.Event()

        def sample():
            while not self.stop.wait(0.005):
                self.peak = max(self.peak, self.rss())

        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.rss())


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(path)
               for n in names)


def tree_digests(tree):
    out = {}
    for keys, leaf in train_checkpoint.orbax_leaves(tree):
        if leaf is None:
            continue
        t = leaf.contiguous()
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[".".join(k for _, k in keys)] = {
            "sha256": hashlib.sha256(words.numpy().tobytes()).hexdigest(),
            "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}
    return out


def orbax_fixture_check():
    """(a) The committed JAX-written fixture decodes on this machine (its g++
    build of the decoder on real zstd frames) to the digests recorded
    beside it."""
    with open(os.path.join(ORBAX_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    native_io.load_zstd()  # g++ builds it here at first use
    build_s = time.perf_counter() - t0
    with DecoderClock() as clock:
        t0 = time.perf_counter()
        tree = train_checkpoint.read_orbax_tree(ORBAX_FIXTURE)
        read_s = time.perf_counter() - t0
    got = tree_digests(tree)
    if got != want:
        bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"orbax fixture: {len(bad)} arrays differ from digests.json, "
                             f"e.g. {bad[:3]}")
    # the steady rate: the fixture's largest chunk frame decoded again and again
    reader = OcdbtReader(ORBAX_FIXTURE)
    key = max((k for k in reader.keys() if not k.endswith(".zarray")),
              key=lambda k: len(reader.read(k)))
    frame = bytes(reader.read(key))
    reader.close()
    out = np.empty(native_io.zstd_content_size(frame) or want_bytes(want, key), np.uint8)
    reps = 400
    t0 = time.perf_counter()
    for _ in range(reps):
        native_io.zstd_decompress(frame, out=out)
    steady = reps * out.nbytes / (time.perf_counter() - t0) / 1e6
    return {"arrays": len(got), "dir_bytes": dir_bytes(ORBAX_FIXTURE), "build_s": build_s,
            "read_s": read_s, **clock.summary(), "steady_frame": key,
            "steady_frame_bytes": len(frame), "steady_MBps": steady}


def want_bytes(digests, chunk_key):
    """The bytes of the array a chunk key (``<name>/0.0``) holds, from its
    recorded shape and dtype, for a frame that declares no content size."""
    entry = digests[chunk_key.rsplit("/", 1)[0]]
    return int(np.prod(entry["shape"])) * np.dtype(entry["dtype"]).itemsize


def state_tensors(state):
    """name -> tensor of a TrainState's parameters and moments."""
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    for group in ("mu", "nu", "acc"):
        for n, t in state.opt_state.get(group, {}).items():
            out[f"{group} {n}"] = t
    return out


def orbax_train_argv(out_dir, train_file, steps):
    return ["--output_dir", out_dir, "--train_file", train_file, "--model_type", "rdot_nll",
            "--model_name_or_path", "init", "--query", "no_res", "--ranking_task",
            "--num_negatives", str(TRAIN_NEG), "--per_gpu_train_batch_size", str(TRAIN_B),
            "--max_concat_length", str(TRAIN_T), "--max_doc_length", str(DOC_T),
            "--learning_rate", "1e-5", "--max_steps", str(steps), "--save_steps", "0",
            "--resume"]


def orbax_path(paths, smi):
    """Phase O at full width: (a) the committed fixture's digests; (b) phase
    4's f32 TrainState after 2 steps saved as an orbax ``checkpoint-2`` and
    restored into a fresh state, every parameter and moment ``torch.equal``;
    (c) ``run_convdr_inference`` from an orbax dir of the trained student,
    its TREC run byte-identical to the one from the same weights as the
    port's own model dir; (d) ``run_convdr_train --resume`` 2 steps from the
    orbax ``checkpoint-2`` and from the port's ``train_state.pt``, losses
    and parameters bit-identical. The kernels' counts are zeroed before and
    read after."""
    t_phase = time.time()
    work = os.path.join(WORK, "orbax")
    os.makedirs(work)
    fixture = orbax_fixture_check()
    log(f"  (a) JAX-written fixture: {fixture['arrays']} arrays equal to their digests; "
        f"{fixture['frames']} zstd frames, {fixture['decoded_bytes']} bytes decoded in "
        f"{fixture['decoder_s'] * 1e3:.2f} ms = {fixture['decoder_MBps']:.1f} MB/s (largest "
        f"frame {fixture['largest_frame_bytes']} bytes); read {fixture['read_s'] * 1e3:.1f} ms "
        f"after the decoder's g++ build ({fixture['build_s']:.2f} s); its largest chunk "
        f"frame ({fixture['steady_frame']}, {fixture['steady_frame_bytes']} bytes) decoded "
        f"400 times at {fixture['steady_MBps']:.1f} MB/s")
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    fused_scores_groupmax.launches = 0
    dma_gather_groups.launches = 0
    device = torch.device("cuda")
    # (b) two f32 steps at phase 4's settings, then an orbax round trip
    _, tok, student = load_model_and_params("rdot_nll", "init", device=device, seed=42,
                                            f32_params=True)
    teacher = load_model_and_params("rdot_nll", "init", device=device, seed=0)[2]
    teacher.requires_grad_(False)
    config = TrainConfig(ranking_task=True, num_negatives=TRAIN_NEG, learning_rate=1e-5,
                         per_device_batch_size=TRAIN_B, max_concat_length=TRAIN_T,
                         max_doc_length=DOC_T)
    state, tx = create_train_state(student, config, TRAIN_STEPS)
    step = make_train_step(student, teacher, tx, config)
    rng = np.random.default_rng(11)
    for _ in range(2):
        state, _m = step(state, train_step_batch(rng))
    torch.cuda.synchronize()
    del teacher, step
    resume_orbax = os.path.join(work, "resume_orbax")
    ckpt = os.path.join(resume_orbax, "checkpoint-2")
    t0 = time.perf_counter()
    train_checkpoint.save_orbax_checkpoint(
        ckpt, train_checkpoint.orbax_tree_of(state, config.weight_decay),
        metadata={"global_step": 2})
    write_s = time.perf_counter() - t0
    ckpt_bytes = dir_bytes(ckpt)
    fresh_model = load_model_and_params("rdot_nll", "init", device=device, seed=7,
                                        f32_params=True)[2]
    fresh, _ = create_train_state(fresh_model, config, TRAIN_STEPS)
    with PeakRss() as rss, DecoderClock() as clock:
        t0 = time.perf_counter()
        fresh = train_checkpoint.restore_checkpoint(ckpt, fresh)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    source, back = state_tensors(state), state_tensors(fresh)
    differ = [n for n, t in source.items() if not torch.equal(t, back[n])]
    if (differ or set(source) != set(back) or fresh.step != 2
            or fresh.opt_state["count"] != state.opt_state["count"]):
        raise AssertionError(f"orbax round trip: {len(differ)} tensors differ, e.g. {differ[:3]}")
    full = {"dir_bytes": ckpt_bytes, "write_s": write_s, "read_s": read_s,
            "tensors": len(source), "rss_before_read_bytes": rss.start,
            "peak_rss_over_read_bytes": rss.peak, **clock.summary()}
    log(f"  (b) full-width f32 TrainState (params + mu + nu, {len(source)} tensors) after 2 "
        f"steps: orbax dir {ckpt_bytes / 1e6:.1f} MB written in {write_s:.2f} s, restored in "
        f"{read_s:.2f} s (raw-block frames decoded at {full['decoder_MBps']:.0f} MB/s); host "
        f"RSS {rss.start / 2**20:.0f} MiB before the read, peak {rss.peak / 2**20:.0f} MiB "
        f"over it; every tensor torch.equal")
    del fresh, fresh_model, back
    torch.cuda.empty_cache()
    # (c) inference from an orbax dir and from the port's own dir
    model_dirs = {"orbax": os.path.join(work, "model_orbax"),
                  "port": os.path.join(work, "model_port")}
    train_checkpoint.save_orbax_checkpoint(
        os.path.join(model_dirs["orbax"], "final"), train_checkpoint.orbax_tree_of(student),
        metadata={"model_type": "rdot_nll", "global_step": 2})
    os.makedirs(model_dirs["port"])
    torch.save({k: v.detach().float().cpu() for k, v in student.state_dict().items()},
               os.path.join(model_dirs["port"], "pytorch_model.bin"))
    for d in model_dirs.values():
        tok.save_pretrained(d)
    runs, infer_s = {}, {}
    for name, d in model_dirs.items():
        argv = inference_argv(work, paths["processed"], paths["raw"], paths["emb_dir"],
                              run_name=f"run_{name}")
        argv[argv.index("--model_path") + 1] = d
        t0 = time.time()
        run_convdr_inference.main(argv)
        torch.cuda.synchronize()
        infer_s[name] = time.time() - t0
        with open(os.path.join(work, f"run_{name}.trec"), "rb") as f:
            runs[name] = f.read()
    if runs["orbax"] != runs["port"] or not runs["orbax"]:
        raise AssertionError("the TREC run from the orbax dir differs from the port dir's")
    log(f"  (c) run_convdr_inference --model_path <orbax dir> {infer_s['orbax']:.1f} s, from "
        f"the port's dir {infer_s['port']:.1f} s: TREC runs byte-identical "
        f"({len(runs['orbax'])} bytes)")
    # (d) resume 2 steps through the driver from each format
    resume_port = os.path.join(work, "resume_port")
    train_checkpoint.save_checkpoint(os.path.join(resume_port, "checkpoint-2"), state,
                                     metadata={"global_step": 2})
    del state, student
    torch.cuda.empty_cache()
    train_file = os.path.join(work, "train.jsonl")
    make_train_file(train_file)
    resumed, resume_s = {}, {}
    for name, out_dir in (("orbax", resume_orbax), ("port", resume_port)):
        t0 = time.time()
        run_convdr_train.main(orbax_train_argv(out_dir, train_file, 4))
        torch.cuda.synchronize()
        resume_s[name] = time.time() - t0
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        params = torch.load(os.path.join(out_dir, "pytorch_model.bin"), weights_only=True)
        resumed[name] = (losses, params)
    (loss_o, par_o), (loss_p, par_p) = resumed["orbax"], resumed["port"]
    if len(loss_o) != 2 or loss_o != loss_p or set(par_o) != set(par_p) or not all(
            torch.equal(par_o[k], par_p[k]) for k in par_p):
        raise AssertionError(f"resume from orbax differs from resume from train_state.pt: "
                             f"losses {loss_o} vs {loss_p}")
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"phase O did not run through its kernels: {launches}")
    log(f"  (d) run_convdr_train --resume 2 steps from the orbax checkpoint-2 "
        f"{resume_s['orbax']:.1f} s, from train_state.pt {resume_s['port']:.1f} s: losses "
        f"{loss_o} bit-identical, parameters torch.equal; launches {launches}")
    phase_s = time.time() - t_phase
    log(f"phase O on {smi}: fixture decoder {fixture['decoder_MBps']:.1f} MB/s, "
        f"{fixture['steady_MBps']:.1f} MB/s steady on its largest frame; full-width "
        f"TrainState dir {ckpt_bytes} bytes, write {write_s:.3f} s, read {read_s:.3f} s, "
        f"peak RSS over the read {rss.peak} bytes; phase {phase_s:.1f} s")
    return {"fixture": fixture, "full_width_state": full, "inference_s": infer_s,
            "resume_s": resume_s, "resumed_losses": loss_o, "launches": launches,
            "phase_s": phase_s}


def rehearsal_path():
    """The port's quality rehearsal (``--smoke``: tiny width, 1500 passages,
    6 topics x 4 turns, 500 steps) on the card; its asserts decide: zero
    oracle mismatches, NDCG@3 and MRR higher after training. The kernels'
    counts are zeroed before and read after."""
    for fn in (flash_attention, flash_attention_bwd, fused_scores_groupmax, dma_gather_groups):
        fn.launches = 0
    t0 = time.time()
    summary = rehearsal.main(["--workdir", os.path.join(WORK, "rehearsal"), "--smoke"])
    torch.cuda.synchronize()
    t_all = time.time() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches}
    if min(launches.values()) == 0 or summary["config"]["device"] != "cuda":
        raise AssertionError(f"rehearsal did not run through its kernels: {launches}")
    base, post = summary["baseline"], summary["trained"]
    log(f"  rehearsal --smoke in {t_all:.1f} s: NDCG@3 {base['ndcg_cut_3']} -> "
        f"{post['ndcg_cut_3']}, MRR {base['mrr']} -> {post['mrr']}, recall@100 "
        f"{base['recall_100']} -> {post['recall_100']}, oracle mismatches "
        f"{summary['oracle_set_mismatches_8q']}/8; stages (s) {summary['stage_seconds']}; "
        f"launches {launches}")
    return {"launches": launches, "seconds": t_all, **summary}


# ---------------------------------------------------------------------------
# the ANN family: k-means, IVF, PQ/OPQ, IVFPQ, the refine store, the drivers
# ---------------------------------------------------------------------------
class StageTimes:
    """Host seconds spent in the index builders' k-means fits and
    assignments while active (a shim around the names ``retrieval.ivf``
    calls; both return host arrays, so the device work is inside)."""

    def __enter__(self):
        self.seconds = collections.Counter()
        self.real = {name: getattr(ivf_module, name) for name in ("fit_kmeans", "assign_top_t")}
        for name, fn in self.real.items():
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.time()
                out = _fn(*a, **kw)
                self.seconds[_name] += time.time() - t0
                return out
            setattr(ivf_module, name, timed)
        return self.seconds

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(ivf_module, name, fn)


def ann_corpus(gen):
    """ANN_N seeded rows of a Gaussian mixture (ANN_CENTRES centres, noise
    of the centres' own spread) and ANN_Q queries from the same mixture, on
    the card; the rows also as two f32 ``.cnb`` blocks whose payloads are
    2 * row + 1."""
    centres = torch.randn(ANN_CENTRES, SEARCH_D, generator=gen, device="cuda")
    which = torch.randint(0, ANN_CENTRES, (ANN_N + ANN_Q,), generator=gen, device="cuda")
    x = centres[which] + torch.randn(ANN_N + ANN_Q, SEARCH_D, generator=gen, device="cuda")
    rows, q = x[:ANN_N].contiguous(), x[ANN_N:].contiguous()
    blocks = os.path.join(WORK, "ann_blocks")
    host = rows.cpu().numpy()
    half = ANN_N // 2
    for b in range(2):
        write_embedding_block(blocks, b, host[b * half:(b + 1) * half],
                              2 * np.arange(b * half, (b + 1) * half, dtype=np.int64) + 1,
                              fmt="native")
    return rows, q, host, blocks


def ann_sets(got_ids, want_s, want_i, score_of, tol):
    """Each query's top-k ids against a reference's: equal sets, or ids that
    differ only in near-ties at the reference's k-th score (within tol[r]).
    Returns the count of queries whose sets are equal."""
    equal = 0
    for r in range(len(got_ids)):
        diff = (set(got_ids[r].tolist()) ^ set(want_i[r].tolist())) - {-1}
        if not diff:
            equal += 1
            continue
        for row in diff:
            if abs(score_of(r, row) - want_s[r, -1]) > tol[r]:
                raise AssertionError(f"query {r}: top-k sets differ beyond near-ties ({row})")
    return equal


def recall_at(got_ids, want_i):
    return float(np.mean([len(set(g.tolist()) & set(w.tolist())) / want_i.shape[1]
                          for g, w in zip(got_ids, want_i)]))


def check_peak(name, mib, adc=False):
    """An IVF search's peak above what was allocated before stays under its
    candidate budget (and the ADC's, for PQ-code lists) plus the slack."""
    limit = ANN_BUDGET_MIB + (ADC_BUDGET_MIB if adc else 0) + ANN_SLACK_MIB
    if mib > limit:
        raise AssertionError(f"{name}: peak {mib:.0f} MiB above the {limit} MiB bound")


def timed_search(fn, queries):
    """(result, ms, peak MiB above what was allocated before) of
    ``fn(queries)``, after a warm-up call on four of them (which uploads
    the index)."""
    fn(queries[:4])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn(queries)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def adc_oracle_dev(lut, codes):
    """``pq_adc_oracle``'s sum on the card, in its order: scores[q, n] =
    sum over m ascending of lut[q, m, codes[n, m]] in f32."""
    codes = codes.long()
    scores = torch.zeros(lut.shape[0], codes.shape[0], device="cuda")
    for m in range(lut.shape[1]):
        scores += lut[:, m, :][:, codes[:, m]]
    return scores


def adc_reference(lut, codes):
    """The oracle's ADC sums on the card, their top-100 and each query's
    near-tie tolerance at the cut (1e-5 of the sum of each subspace's
    largest |LUT| entry); the sums equal ``pq_adc_oracle``'s on the first
    two queries, bit for bit."""
    ref = adc_oracle_dev(lut, codes)
    ref_s, ref_i = stable_topk(ref, TOP_N)
    few = pq_adc_oracle(lut[:2].cpu().numpy(), codes.cpu().numpy(), TOP_N)
    if not (np.array_equal(few[0], ref_s[:2].cpu().numpy())
            and np.array_equal(few[1], ref_i[:2].cpu().numpy())):
        raise AssertionError("the card's ADC oracle differs from pq_adc_oracle")
    tol = (1e-5 * lut.abs().amax(dim=2).sum(dim=1)).cpu().numpy()
    return ref, ref_s.cpu().numpy(), ref_i.cpu().numpy(), tol


def check_adc(name, search_rows, queries, reference, exact_i):
    """The ADC top-100 of ``search_rows(queries)`` (row positions) against
    ``adc_reference``'s, up to near-ties at the cut. Returns the recall@100
    against the exact search, the ms and the peak MiB."""
    q_count = len(queries)
    (_s, pos), ms, mib = timed_search(search_rows, queries)
    ref, ref_s, ref_i, tol = reference
    equal = ann_sets(pos, ref_s, ref_i, lambda r, p: ref[r, p].item(), tol)
    rec = recall_at(pos, exact_i[:q_count])
    log(f"  {name}: ADC top-{TOP_N} sets equal to the oracle's for {equal}/{q_count} "
        f"queries (near-ties otherwise); recall@{TOP_N} {rec:.4f}; {ms:.1f} ms for "
        f"{q_count} queries, peak {mib:.0f} MiB")
    return {"oracle_equal_queries": equal, "recall_100": rec, "ms": ms, "peak_mib": mib}


def ann_path(paths, flat_metrics, qids, q_embs):
    """Phase 4d: the ANN family at full width (D=768) over a 1M-row seeded
    mixture, then the two ANN drivers over the phase-3 embed driver's
    blocks. Kernel 1's count is zeroed before the driver run and read
    after; the ANN layer itself is PyTorch ops."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    t_phase = time.time()
    rows, q, host, blocks = ann_corpus(gen)
    q_np = q.cpu().numpy()
    pnorm = rows.norm(dim=1).max().item()
    tol = (1e-5 * q.norm(dim=1) * pnorm).cpu().numpy()
    exact_s, exact_i = flat_ip_topk(q, rows, TOP_N)
    exact_s, exact_i = exact_s.cpu().numpy(), exact_i.cpu().numpy()

    def score_of(r, row):
        return (q[r] @ rows[row]).item()

    def to_pos(ids):
        return np.where(ids >= 0, (ids - 1) // 2, -1)

    out = {}
    # IVF f32 through build_from_blocks
    with StageTimes() as stage:
        t0 = time.time()
        ivf_f32 = IVFIndex.build_from_blocks(blocks, ANN_NLIST, slack=1.0, iters=20, seed=0)
        build_s = time.time() - t0
    out["ivf_f32_build"] = {"seconds": build_s, **stage, "stats": ivf_f32.stats}
    log(f"  IVF f32 build_from_blocks: {build_s:.2f} s (k-means {stage['fit_kmeans']:.2f} s, "
        f"assignment {stage['assign_top_t']:.2f} s, block reads + layout + pack the rest); "
        f"{ivf_f32.stats}")
    (s, ids), ms, mib = timed_search(
        lambda qs: ivf_f32.search(qs, TOP_N, nprobe=ivf_f32.nlist), q_np)
    equal = ann_sets(to_pos(ids), exact_s, exact_i, score_of, tol)
    check_peak("IVF f32 full probe", mib)
    log(f"  IVF f32 full probe ({ivf_f32.nlist} sub-lists): top-{TOP_N} sets equal to "
        f"flat_ip_topk's for {equal}/{ANN_Q} queries (near-ties otherwise); {ms:.1f} ms, "
        f"peak {mib:.0f} MiB")
    sweep = {"full": {"ms": ms, "peak_mib": mib, "exact_equal_queries": equal}}
    for nprobe in ANN_NPROBES:
        (s, ids), ms, mib = timed_search(
            lambda qs: ivf_f32.search(qs, TOP_N, nprobe=nprobe), q_np)
        sweep[nprobe] = {"recall_100": recall_at(to_pos(ids), exact_i), "ms": ms,
                         "peak_mib": mib}
        check_peak(f"IVF f32 nprobe {nprobe}", mib)
        log(f"  IVF f32 nprobe {nprobe}: recall@{TOP_N} {sweep[nprobe]['recall_100']:.4f}, "
            f"{ms:.1f} ms for {ANN_Q} queries, peak {mib:.0f} MiB")
    out["ivf_f32"] = sweep
    # where an nprobe-32 search spends the card's time: the sub-list gather
    # (index_select), the product (bmm), the top-k
    trace_dir = os.path.join(WORK, "ann_trace")
    with profile_trace(trace_dir):
        ivf_f32.search(q_np, TOP_N, nprobe=32)
        torch.cuda.synchronize()
    trace = trace_summary(trace_dir)
    out["ivf_f32_nprobe32_trace"] = trace
    log(f"  IVF f32 nprobe 32 trace: span {trace['span_ms']:.1f} ms, device busy "
        f"{trace['device_busy_share']:.4f} of it; by kernel " + ", ".join(
            f"{k} {v['launches']}x {v['ms']:.3f} ms"
            for k, v in list(trace["by_kernel"].items())[:6]))
    # the int8 build reuses these k-means centroids (one a cluster, in
    # cluster order; the f32 index holds one a sub-list)
    _u, first = np.unique(ivf_f32.centroids, axis=0, return_index=True)
    centroids = ivf_f32.centroids[np.sort(first)]
    del ivf_f32
    torch.cuda.empty_cache()

    # IVF int8 over the same rows: a full probe, score for score
    t0 = time.time()
    ivf_i8 = IVFIndex.build(host, ANN_NLIST, storage_dtype="int8", centroids=centroids)
    build_s = time.time() - t0
    (s, ids), ms, mib = timed_search(
        lambda qs: ivf_i8.search(qs, TOP_N, nprobe=ivf_i8.nlist), q_np)
    quant = ivf_i8.quantizer
    q_int = torch.from_numpy(quant.quantize_queries(q_np)[0]).cuda()
    p_int = quantize_passages_dev(rows, torch.from_numpy(quant.scales).cuda()).float()
    int_scores = q_int @ p_int.T
    ref_s, ref_i = stable_topk(int_scores, TOP_N)
    tq = quant.quantize_queries(q_np)[1]
    if not np.array_equal(np.sort(s, 1), np.sort(ref_s.cpu().numpy() * tq, 1)):
        raise AssertionError("IVF int8 full-probe scores differ from the integer-exact search")
    check_peak("IVF int8 full probe", mib)
    ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
    equal = ann_sets(ids, ref_s, ref_i, lambda r, p: int_scores[r, p].item(),  # row ids
                     np.zeros(ANN_Q))
    del p_int, int_scores
    out["ivf_int8"] = {"build_s": build_s, "ms": ms, "peak_mib": mib, "equal_sets": equal}
    ivf_i8.save(SERVE_IVF_DIRS["ivf_int8"])  # the serving phase's resident IVF int8
    log(f"  IVF int8 (build {build_s:.2f} s on the f32 index's centroids): full-probe scores equal to the integer-exact "
        f"plain search score for score for {ANN_Q}/{ANN_Q} queries, sets equal for "
        f"{equal} (integer ties at the cut otherwise); {ms:.1f} ms, peak {mib:.0f} MiB")
    del ivf_i8
    torch.cuda.empty_cache()

    # flat pq4 (packed) at Q=512, its IVFPQ promotion, the refine store
    t0 = time.time()
    pq4 = PQIndex.build_from_blocks(blocks, 96, 4, iters=20, seed=0, pack=True)
    build_s = time.time() - t0
    codes4 = torch.from_numpy(unpack_codes_4bit(pq4.codes)).cuda()
    lut4 = round_lut(torch.from_numpy(pq4.codec.lut(q_np)).cuda(), exact=False)
    ref4 = adc_reference(lut4, codes4)  # the flat scan's and the IVFPQ's (codes verbatim)
    out["pq4_flat"] = check_adc(f"flat pq4 m=96 packed (build {build_s:.2f} s)",
                                lambda qs: pq4.adc_topk(qs, TOP_N), q_np, ref4, exact_i)
    out["pq4_flat"]["build_s"] = build_s
    t0 = time.time()
    ivfpq = IVFIndex.from_pq_index(pq4, blocks, ANN_NLIST, iters=20, seed=0)
    build_s = time.time() - t0
    out["ivfpq_full"] = check_adc(
        f"IVFPQ from_pq_index full probe, {ivfpq.nlist} sub-lists (build {build_s:.2f} s)",
        lambda qs: [to_pos(a) for a in ivfpq.search(qs, TOP_N, nprobe=ivfpq.nlist)],
        q_np, ref4, exact_i)
    out["ivfpq_full"]["build_s"] = build_s
    check_peak("IVFPQ full probe", out["ivfpq_full"]["peak_mib"], adc=True)
    (s, ids), ms, mib = timed_search(lambda qs: ivfpq.search(qs, TOP_N, nprobe=32), q_np)
    check_peak("IVFPQ nprobe 32", mib, adc=True)
    out["ivfpq_nprobe32"] = {"recall_100": recall_at(to_pos(ids), exact_i), "ms": ms,
                             "peak_mib": mib}
    log(f"  IVFPQ nprobe 32: recall@{TOP_N} {out['ivfpq_nprobe32']['recall_100']:.4f}, "
        f"{ms:.1f} ms, peak {mib:.0f} MiB")
    ivfpq.save(SERVE_IVF_DIRS["ivfpq_pq4"])  # and its resident packed IVFPQ
    del ivfpq, codes4, ref4
    # --rescore_factor 2 through the refine store on the .cnb blocks, index
    # for index against a plain refine of the same candidates (rows by
    # position from memory, the same per-row f32 dot, a stable sort)
    _s, cand = pq4.adc_topk(q_np, 2 * TOP_N)
    t0 = time.time()
    ref_s, ref_ids = pq4.rescore(blocks, q_np, cand, TOP_N)
    refine_ms = (time.time() - t0) * 1e3
    qi = np.repeat(np.arange(ANN_Q), cand.shape[1])
    plain = np.einsum("cd,cd->c", host[cand.reshape(-1)], q_np[qi],
                      dtype=np.float32).reshape(cand.shape)
    key = np.argsort(cand, axis=1, kind="stable")
    cand_sorted = np.take_along_axis(cand, key, 1)
    plain = np.take_along_axis(plain, key, 1)
    order = np.argsort(-plain, axis=1, kind="stable")[:, :TOP_N]
    want = 2 * np.take_along_axis(cand_sorted, order, 1) + 1
    if not (np.array_equal(ref_ids, want)
            and np.array_equal(ref_s, np.take_along_axis(plain, order, 1))):
        raise AssertionError("the refine store's rescore differs from the plain refine")
    rec = recall_at(to_pos(ref_ids), exact_i)
    out["pq4_rescore2"] = {"refine_ms": refine_ms, "recall_100": rec}
    log(f"  pq4 + rescore 2 through the refine store (.cnb): equal to the plain refine "
        f"index for index; recall@{TOP_N} {rec:.4f}; refine {refine_ms:.1f} ms")
    del pq4

    # flat pq8 (m 96) at Q=64: its one-hot is 96 x 256 = 24,576 wide, so a
    # row block costs 16x pq4's one-hot bytes and Q=512 would be 8x the
    # product's work; 64 queries keep the phase short
    t0 = time.time()
    pq8 = PQIndex.build(host, 96, 8, iters=20, seed=0)
    build_s = time.time() - t0
    codes8 = torch.from_numpy(pq8.codes).cuda()
    lut8 = round_lut(torch.from_numpy(pq8.codec.lut(q_np[:PQ8_Q])).cuda(), exact=False)
    out["pq8_flat"] = check_adc(f"flat pq8 m=96 (build {build_s:.2f} s)",
                                lambda qs: pq8.adc_topk(qs, TOP_N), q_np[:PQ8_Q],
                                adc_reference(lut8, codes8), exact_i)
    out["pq8_flat"]["build_s"] = build_s
    del pq8, codes8
    del rows, q
    torch.cuda.empty_cache()
    shutil.rmtree(blocks, ignore_errors=True)
    out["library_s"] = time.time() - t_phase

    # the drivers over the phase-3 embed driver's f32 blocks
    emb_dir, ivf_dir = paths["emb_dir"], os.path.join(WORK, "ivf_index")
    t0 = time.time()
    summary = build_ivf_index.main(["--ann_data_dir", emb_dir, "--index_dir", ivf_dir,
                                    "--nlist", str(DRIVER_NLIST)])
    out["driver_build_s"] = time.time() - t0
    if summary["nlist"] > 999:  # --nprobe 999 must probe every sub-list
        raise AssertionError(f"{summary['nlist']} sub-lists")
    flash_attention.launches = 0
    t0 = time.time()
    full = run_convdr_inference.main(inference_argv(WORK, paths["processed"], paths["raw"],
                                                    emb_dir, "run_ivf")
                                     + ["--ivf_dir", ivf_dir, "--nprobe", "999"])
    torch.cuda.synchronize()
    out["driver_full_probe_s"] = time.time() - t0
    launches = flash_attention.launches
    for name, value in flat_metrics.items():
        if abs(full[name] - value) > 1e-6:
            raise AssertionError(f"--ivf_dir --nprobe 999: {name} {full[name]} != flat {value}")
    # the run file, pid for pid: held to the exact plain search (sets equal
    # but for near-ties at the cut) and to the flat f32 run's file rank by
    # rank (equal pids, or near-ties in another order)
    run = parse_trec_run(os.path.join(WORK, "run_ivf.trec"))
    flat = parse_trec_run(paths["trec"])
    rows, offs = load_rows(emb_dir)
    q_dev = torch.from_numpy(q_embs).cuda()
    exact = run_matches_exact(run, qids, q_dev, rows, offs + 1000)
    same_rank, rank_gap = ranks_match(run, flat, qids, q_dev, rows, offs + 1000)
    del rows, offs
    torch.cuda.empty_cache()
    same_set = sum({p for p, _ in run[qid]} == {p for p, _ in flat[qid]} for qid in qids)
    out["driver_full_probe_run"] = {"exact_equal_queries": exact, "flat_equal_sets": same_set,
                                    "flat_equal_ranks": same_rank, "rank_gap_of_tol": rank_gap,
                                    "queries": len(qids)}
    t0 = time.time()
    one = run_convdr_inference.main(inference_argv(WORK, paths["processed"], paths["raw"],
                                                   emb_dir, "run_ivf1")
                                    + ["--ivf_dir", ivf_dir, "--nprobe", "1"])
    out["driver_nprobe1_s"] = time.time() - t0
    if launches == 0 or not all(0.0 <= v <= 1.0 for v in one.values()):
        raise AssertionError(f"the IVF driver run: {launches} attention launches, {one}")
    out.update(driver_summary=summary, driver_full_probe_metrics=full,
               driver_nprobe1_metrics=one, flash_attention_launches=launches,
               phase_s=time.time() - t_phase)
    log(f"  build_ivf_index over the phase-3 blocks ({summary['ntotal']} rows, "
        f"{summary['nlist']} sub-lists) {out['driver_build_s']:.1f} s; run_convdr_inference "
        f"--ivf_dir --nprobe 999 {out['driver_full_probe_s']:.1f} s, metrics equal to the flat "
        f"f32 run's {full}; its run file's top-{TOP_N} sets equal the exact search's for "
        f"{exact}/{len(qids)} queries (near-ties otherwise), the flat run's sets for "
        f"{same_set} and its ranks pid for pid for {same_rank} (near-ties in another order "
        f"otherwise, the widest {rank_gap:.3f} of the tolerance); --nprobe 1 {out['driver_nprobe1_s']:.1f} s {one}; kernel 1 "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# 4e. online serving: one captured CUDA graph a turn
# ---------------------------------------------------------------------------
def make_histories(n):
    """n distinct three-turn conversations, the current question last
    (scripts/bench_online.py's)."""
    subjects = ["throat cancer", "bronze age trade", "lucid dreaming", "coral reefs",
                "rust compilers", "monsoon seasons", "jazz harmony", "glacier melt"]
    return [[f"tell me about {subjects[i % len(subjects)]} case {i}",
             f"what causes it in region {i % 7}",
             f"how is it treated or managed today, variant {i}"] for i in range(n)]


def latency_ms(lat):
    """count and p50 / p90 / p99 / mean in ms of latencies in seconds."""
    a = np.asarray(lat) * 1e3
    return {"count": len(lat), "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)), "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def same_bits(a, b):
    return a[0].tobytes() == b[0].tobytes() and np.array_equal(a[1], b[1])


def graph_ms(fn):
    """Device ms of ``fn()``: captured into a CUDA graph of its own as the
    serving program is (``online.capture``), then replays timed back to
    back with CUDA events, so no host launch time is in it."""
    graph = capture(fn, torch.device("cuda"))[0]
    ms = cuda_ms(graph.replay, iters=20)
    del graph
    return ms


def plain_flat_search(rows, storage, emb_dir):
    """The plain exact search a flat backend is held to: one matmul with
    TF32 off over every row of the blocks on disk (``rows``, f32 on the
    card), stored as the backend stores them (f32; bf16; SQ8 with the
    scales ``from_blocks`` takes: the sidecar's, else fit on block 0).
    -> q [1, D] f32 -> (scores [N] f32, tol): 1e-5*|q|*max|p| for float
    rows; 0 for SQ8, whose query the host's ``quantize_queries`` folds and
    whose integer products and sums are exact in f32."""
    if storage != "int8":
        stored = rows if storage == "float32" else rows.bfloat16().float()
        pmax = stored.norm(dim=1).max().item()
        return lambda q: ((q @ stored.T)[0], 1e-5 * q.norm().item() * pmax)
    quant = Int8Quantizer.load_optional(emb_dir) or Int8Quantizer.fit(
        next(iter_embedding_blocks(emb_dir))[1])
    scales = torch.from_numpy(quant.scales).cuda()
    p_int = torch.round(rows / scales[None, :]).clamp_(-127, 127)

    def search(q):
        q_int, t = (torch.from_numpy(x).cuda() for x in quant.quantize_queries(q.cpu().numpy()))
        return (q_int @ p_int.T)[0] * t[0, 0], 0.0

    return search


def topk_matches_plain(name, s, rows, plain, tol):
    """Holds one served top-``TOP_N`` (device scores and rows) to a plain
    exact search's scores over every row: the rows are distinct, their
    plain scores lie within ``tol`` of the served ones, none lies below the
    plain k-th score by more than ``tol``, and every row above it by more
    than ``tol`` is served, so the two differ at most in near-ties at the
    cut. Returns whether the two sets are equal."""
    top = torch.topk(plain, TOP_N)
    kth = top.values[-1]
    if ((rows < 0).any() or rows.unique().numel() != TOP_N
            or (plain[rows] - s).abs().max() > tol or (plain[rows] < kth - tol).any()
            or not torch.isin(torch.nonzero(plain > kth + tol).flatten(), rows).all()):
        raise AssertionError(f"{name}: a served top-{TOP_N} differs from the plain exact "
                             f"search beyond near-ties at the cut (tolerance {tol})")
    return set(rows.tolist()) == set(top.indices.tolist())


def serve_backend(name, make, histories, plain=None):
    """One backend: build it (model and resident index), capture the Q=1
    program (``warmup``), serve every history through ``search`` (tokenize
    included) and through ``search_tokens``, then the same turns eagerly in
    two steps (tokenize, encode, read back, search, read back), as
    scripts/bench_online.py compares them. Every served turn is held bit
    for bit to the one-step eager program and to the two-step run, and on
    the flat backends to ``plain``, a plain exact search of its query
    (:func:`topk_matches_plain`). The kernels' counts are zeroed before the build and read after the served
    turns: the eager warm-up's launches plus the graph's recorded launches
    times its replays (the capture's own records launch nothing)."""
    for fn in COUNTED_KERNELS.values():
        fn.launches = 0
    t0 = time.time()
    searcher = make()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    searcher.warmup()
    graph = searcher.graphs[1]
    searcher.stats.latencies.clear()
    served = [searcher.search(h) for h in histories]
    lat_search = list(searcher.stats.latencies)
    length = searcher.max_concat_length
    inputs = [history_to_inputs(searcher.tokenizer, h, max_concat_length=length)
              for h in histories]
    searcher.stats.latencies.clear()
    served_tokens = [searcher.search_tokens(ids, mask) for ids, mask in inputs]
    lat_tokens = list(searcher.stats.latencies)
    counted, replayed = {k: fn.launches for k, fn in COUNTED_KERNELS.items()}, \
        searcher.replayed_launches()
    launches = {k: counted[k] - graph.launches[k] + replayed[k] for k in counted}
    lat_eager = []
    for h, got in zip(histories, served_tokens):
        t1 = time.perf_counter()
        ids, mask = history_to_inputs(searcher.tokenizer, h, max_concat_length=length)
        q = searcher.encode(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu()
        s, i = searcher.search_embeddings(q.cuda())
        two_step = (s.cpu().numpy(), searcher.rows_to_offsets(i.cpu().numpy()))
        lat_eager.append(time.perf_counter() - t1)
        if not same_bits(two_step, got):
            raise AssertionError(f"{name}: a replay differs from the two-step eager run")
    plain_sets_equal = 0
    for (ids, mask), a, b in zip(inputs, served, served_tokens):
        ids_dev, mask_dev = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
        s, i = searcher.program(ids_dev, mask_dev)
        want = (s.cpu().numpy(), searcher.rows_to_offsets(i.cpu().numpy()))
        if not (same_bits(a, want) and same_bits(b, want)):
            raise AssertionError(f"{name}: a replay differs from the eager program")
        if (want[0].shape != (1, TOP_N) or (want[1] < 0).any()
                or not np.isfinite(want[0]).all() or (np.diff(want[0]) > 0).any()):
            raise AssertionError(f"{name}: a turn's top-{TOP_N} is malformed")
        if plain is not None:
            plain_sets_equal += topk_matches_plain(
                name, s[0], i[0], *plain(searcher.encode(ids_dev, mask_dev)))
    ids_dev, mask_dev = (torch.from_numpy(x).cuda() for x in inputs[-1])
    q_dev = searcher.encode(ids_dev, mask_dev)
    out = {
        "build_s": build_s, "capture_s": graph.capture_s,
        "resident_mib": searcher.resident_bytes / 2 ** 20,
        "model_mib": sum(p.numel() * p.element_size()
                         for p in searcher.model.parameters()) / 2 ** 20,
        "graph_pool_mib": graph.pool_bytes / 2 ** 20,
        "search": latency_ms(lat_search), "search_tokens": latency_ms(lat_tokens),
        "eager_two_step": latency_ms(lat_eager),
        "replay_device_ms": cuda_ms(graph.graph.replay, iters=20),
        "encode_device_ms": graph_ms(lambda: searcher.encode(ids_dev, mask_dev)),
        "search_device_ms": graph_ms(lambda: searcher.search_embeddings(q_dev)),
        "eager_encode_ms": cuda_ms(lambda: searcher.encode(ids_dev, mask_dev), iters=20),
        "eager_search_ms": cuda_ms(lambda: searcher.search_embeddings(q_dev), iters=20),
        "launches": launches, "launches_per_replay": graph.launches,
        "replays": graph.replays, "turns_equal_to_eager": len(histories),
        "turns_held_to_plain": len(histories) if plain is not None else 0,
        "plain_sets_equal": plain_sets_equal,
    }
    log(f"  {name}: build {build_s:.2f} s, capture {graph.capture_s:.3f} s; resident "
        f"{out['resident_mib']:.1f} MiB (model {out['model_mib']:.1f}), graph pool "
        f"{out['graph_pool_mib']:.1f} MiB; p50 / p90 / p99 ms: search "
        + " / ".join(f"{out['search'][p]:.3f}" for p in ("p50_ms", "p90_ms", "p99_ms"))
        + ", search_tokens "
        + " / ".join(f"{out['search_tokens'][p]:.3f}" for p in ("p50_ms", "p90_ms", "p99_ms"))
        + ", eager two steps "
        + " / ".join(f"{out['eager_two_step'][p]:.3f}" for p in ("p50_ms", "p90_ms", "p99_ms"))
        + f"; device ms: replay {out['replay_device_ms']:.3f} (encode "
        f"{out['encode_device_ms']:.3f}, search {out['search_device_ms']:.3f}; eager, "
        f"host-paced: {out['eager_encode_ms']:.3f}, {out['eager_search_ms']:.3f}); "
        f"{len(histories)} turns equal to the eager program bit for bit; "
        + (f"{plain_sets_equal}/{len(histories)} top-{TOP_N} sets equal to the plain exact "
           "search, near-ties at the cut otherwise; " if plain is not None else "")
        + f"launches {launches} "
        f"({graph.launches} a replay x {graph.replays})")
    # the turn's device share: the replay's device time over the turn's wall
    out["device_share_search_tokens_p50"] = out["replay_device_ms"] / \
        out["search_tokens"]["p50_ms"]
    del searcher, graph, q_dev
    torch.cuda.empty_cache()
    return out


def serving_kernel_times(tokenizer, histories):
    """Kernel 1 at the serving encode's shape (B=1, T=256, f32, the mask of
    a served history); kernel 2 at Q=1 over the flat search's full block
    (524288 rows) and its short last one (``SERVE_SHORT``) with f32, bf16
    and int8 passages; kernel 5 at Q=1 on each of those score blocks and
    the groups their maxima pick. Each against its plain version (attention
    within 1e-5; f32/bf16 scores within 1e-5*|q|*max|p|, int8 scores and
    every gather equal). Timed at the full block, host-paced and on the
    device, beside its bound and one library call (masked SDPA;
    ``torch.matmul`` with TF32 off + ``amax``, none for int8, as
    ``torch._int_mm`` takes no fewer than 17 rows; ``torch.gather``, which
    is also kernel 5's plain version)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    _ids, mask = history_to_inputs(tokenizer, histories[0], max_concat_length=SERVE_T)
    mask = torch.from_numpy(mask).cuda()
    q, k, v = (torch.randn((1, SERVE_T, HEADS, HEAD_DIM), generator=gen, device="cuda")
               for _ in range(3))
    err = (flash_attention(q, k, v, mask) - flash_attention_plain(q, k, v, mask)).abs().max()
    if err.item() > 1e-5:
        raise AssertionError(f"flash attention at B=1 T={SERVE_T}: {err.item()}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    kernel = lambda: flash_attention(q, k, v, mask)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed)  # noqa: E731
    bound_ms, bound_by = attention_bound_ms(q, mask)
    attn = {"shape": f"B=1 T={SERVE_T} H={HEADS} D={HEAD_DIM} f32",
            "valid_tokens": int(mask.sum().item()), "max_abs_err": err.item(),
            "ms": cuda_ms(kernel, iters=50), "device_ms": device_ms(kernel, iters=50),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, mask), iters=20),
            "library_ms": cuda_ms(library, iters=50),
            "library_device_ms": device_ms(library, iters=50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "config": flash_attention_fwd_config(1, SERVE_T, HEADS, HEAD_DIM, torch.float32)}
    log(f"  kernel 1 at {attn['shape']} ({attn['valid_tokens']} valid tokens): max_abs_err "
        f"{attn['max_abs_err']:.3e}; {attn['ms']:.4f} ms host-paced, {attn['device_ms']:.4f} "
        f"on the device; plain {attn['plain_ms']:.4f}; SDPA {attn['library_ms']:.4f} / "
        f"{attn['library_device_ms']:.4f}; bound {bound_ms:.4f} ({bound_by}); "
        f"{attn['config']}")
    q32 = torch.randn(1, SEARCH_D, generator=gen, device="cuda")
    p32 = torch.randn(SEARCH_N, SEARCH_D, generator=gen, device="cuda")
    scores, gather = {}, None
    for dtype in STORAGE:
        qd, p = search_operands(q32, p32, dtype)
        diff = 0.0
        for n in (SERVE_SHORT, SEARCH_N):
            s, g = fused_scores_groupmax(qd, p[:n], GROUP)
            s_ref, g_ref = fused_scores_groupmax_plain(qd, p[:n], GROUP)
            diff = max(diff, (s - s_ref).abs().max().item())
            tol = 1e-5 * qd.norm().item() * p[:n].float().norm(dim=1).max().item()
            exact = torch.equal(s, s_ref) and torch.equal(g, g_ref)
            if (dtype == torch.int8 and not exact) or diff > tol:
                raise AssertionError(f"kernel 2 at Q=1 N={n} ({dtype}): {diff}")
            # the groups the flat search gathers from this block
            gsel = torch.sort(grouped_topk_last_axis(g, TOP_N, GROUP)[1], dim=1)[0]
            if not torch.equal(dma_gather_groups(s, gsel, group=GROUP),
                               dma_gather_groups_plain(s, gsel, group=GROUP)):
                raise AssertionError(f"kernel 5 at Q=1 N={n} ({dtype}) differs from "
                                     "torch.gather")
        if gather is None:  # timed once, on the f32 full block's scores
            gather = gather_q1_times(s, gsel)
        call = lambda: fused_scores_groupmax(qd, p, GROUP)  # noqa: E731
        nbytes = (qd.numel() * (1 if dtype == torch.int8 else 4) + p.numel() * p.element_size()
                  + SEARCH_N * 4 + SEARCH_N // GROUP * 4)
        bound_ms, bound_by = kernel_bound(2.0 * SEARCH_N * SEARCH_D, nbytes,
                                          torch.int8 if dtype == torch.int8 else torch.float32)
        row = {"shape": f"Q=1 N={SEARCH_N} D={SEARCH_D} G={GROUP} {dtype_name(dtype)}",
               "max_abs_err": diff, "ms": cuda_ms(call, iters=50),
               "device_ms": device_ms(call, iters=50),
               "plain_ms": cuda_ms(lambda: fused_scores_groupmax_plain(qd, p, GROUP), iters=20),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if dtype == torch.int8:
            row.update(library_ms=None, library=None)
        else:
            lib = library_scores(qd, p, GROUP)
            pf = p.float()
            row.update(lib, library_device_ms=device_ms(
                lambda: torch.matmul(qd, pf.T).view(1, -1, GROUP).amax(-1), iters=50))
        scores[dtype_name(dtype)] = row
        log(f"  kernel 2 at {row['shape']}: max_abs_err {diff:.3e}; {row['ms']:.4f} ms "
            f"host-paced, {row['device_ms']:.4f} on the device; plain {row['plain_ms']:.4f}; "
            f"library {row['library_ms']} ({row.get('library_device_ms')} on the device); "
            f"bound {bound_ms:.4f} ({bound_by})")
        del qd, p, s, g, s_ref, g_ref, gsel
    del p32
    torch.cuda.empty_cache()
    return attn, scores, gather


def gather_q1_times(s, gsel):
    """Kernel 5 at the served shape (Q=1, the full block, K=TOP_N groups),
    host-paced and on the device, beside its bound (the groups read and
    written once, their ids read) and ``torch.gather``."""
    kernel = lambda: dma_gather_groups(s, gsel, group=GROUP)  # noqa: E731
    library = lambda: dma_gather_groups_plain(s, gsel, group=GROUP)  # noqa: E731
    bound_ms, bound_by = kernel_bound(0.0, 2 * gsel.numel() * GROUP * 4 + gsel.numel() * 8)
    row = {"shape": f"Q=1 B={SEARCH_N} K={TOP_N} G={GROUP} f32", "max_abs_err": 0.0,
           "ms": cuda_ms(kernel, iters=50), "device_ms": device_ms(kernel, iters=50),
           "plain_ms": cuda_ms(library, iters=50), "library_ms": cuda_ms(library, iters=50),
           "library_device_ms": device_ms(library, iters=50),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"  kernel 5 at {row['shape']} (and at N={SERVE_SHORT}, every storage): equals "
        f"torch.gather; {row['ms']:.4f} ms host-paced, {row['device_ms']:.4f} on the device; "
        f"torch.gather {row['library_ms']:.4f} / {row['library_device_ms']:.4f}; bound "
        f"{bound_ms:.5f} ({bound_by})")
    return row


def serve_driver_vs_batch(paths, storage):
    """``serve_online.main`` over the main path's 512 evaluation turns
    against ``run_convdr_inference --per_gpu_eval_batch_size 1`` over the
    same f32 blocks (the same encode shape, so the same embedding bits, and
    one f32 FMA chain a score whatever the query tile): the two TREC runs
    rank for rank, and their metrics equal."""
    processed, raw, emb_dir = paths["processed"], paths["raw"], paths["emb_dir"]
    trec = os.path.join(WORK, f"serve_{storage}.trec")
    t0 = time.time()
    served = serve_online.main([
        "--model_path", "init", "--model_type", "rdot_nll",
        "--eval_file", os.path.join(raw, "eval_topics.jsonl"),
        "--processed_data_dir", processed, "--ann_data_dir", emb_dir,
        "--qrels", os.path.join(raw, "qrels.tsv"), "--output_trec_file", trec,
        "--top_n", str(TOP_N), "--max_concat_length", str(SERVE_T),
        "--storage_dtype", storage])
    serve_s = time.time() - t0
    t0 = time.time()
    batch = run_convdr_inference.main(
        inference_argv(WORK, processed, raw, emb_dir, f"batch1_{storage}")
        + ["--per_gpu_eval_batch_size", "1", "--storage_dtype", storage])
    batch_s = time.time() - t0
    run = parse_trec_run(trec)
    ref = parse_trec_run(os.path.join(WORK, f"batch1_{storage}.trec"))
    differ = [qid for qid in ref if [p for p, _ in run.get(qid, [])] != [p for p, _ in ref[qid]]]
    out = {"serve_s": serve_s, "batch_s": batch_s, "queries": len(ref),
           "equal_ranks": len(ref) - len(differ), "serving_latency": served["serving_latency"],
           "metrics_equal": all(served[k] == v for k, v in batch.items())}
    log(f"  serve_online.main --storage_dtype {storage}: {serve_s:.1f} s, per turn "
        f"{served['serving_latency']}; run_convdr_inference --per_gpu_eval_batch_size 1 "
        f"{batch_s:.1f} s; runs rank for rank equal for {out['equal_ranks']}/{len(ref)} "
        f"queries, metrics equal {out['metrics_equal']}")
    if differ or set(run) != set(ref) or not out["metrics_equal"]:
        qid = differ[0] if differ else None
        raise AssertionError(f"serve_online ({storage}) differs from the batch driver at batch "
                             f"1: {len(differ)} queries, e.g. {qid}: "
                             f"{run.get(qid, [])[:5]} against {ref.get(qid, [])[:5]}")
    return out


def serving_path(paths):
    """Phase 4e: online serving at full width (RoBERTa-base rdot_nll, seeded
    weights, concat 256): 64 distinct three-turn histories served one at a
    time by the resident flat corpus of the inference path (1,056,768 x 768;
    f32, bf16, int8) and by the ANN phase's IVF int8 and packed IVFPQ pq4
    indexes (1,048,576 rows; nprobe 8 and 32), each flat turn also held to
    a plain exact search; kernels 1, 2 and 5 at the serving shapes; then
    the serving driver against the batch driver."""
    t_phase = time.time()
    histories = make_histories(SERVE_TURNS)
    common = dict(model_type="rdot_nll", top_n=TOP_N, max_concat_length=SERVE_T)
    backends = {}
    rows, _offsets = load_rows(paths["emb_dir"])
    for storage in ("float32", "bfloat16", "int8"):
        backends[f"flat_{storage}"] = serve_backend(
            f"flat {storage}", lambda st=storage: OnlineSearcher.from_blocks(
                None, paths["emb_dir"], storage_dtype=st, **common), histories,
            plain=plain_flat_search(rows, storage, paths["emb_dir"]))
        torch.cuda.empty_cache()
    del rows, _offsets
    for kind, index_dir in SERVE_IVF_DIRS.items():
        for nprobe in SERVE_NPROBES:
            backends[f"{kind}_nprobe{nprobe}"] = serve_backend(
                f"{kind} nprobe {nprobe}", lambda d=index_dir, n=nprobe: OnlineSearcher.from_ivf(
                    None, d, nprobe=n, **common), histories)
        shutil.rmtree(index_dir, ignore_errors=True)
    for name, b in backends.items():
        flat = name.startswith("flat")
        on_path = [k for k in COUNTED_KERNELS if flat or k == "flash_attention_fwd"]
        if any(b["launches"][k] <= 0 for k in on_path):
            raise AssertionError(f"serving {name} did not run through its kernels: "
                                 f"{b['launches']}")
    tokenizer = load_tokenizer_for(get_model_config("rdot_nll"), None)  # the served one
    attn, scores, gather = serving_kernel_times(tokenizer, histories)
    drivers = {st: serve_driver_vs_batch(paths, st) for st in ("float32", "int8")}
    return {"backends": backends, "kernel1_B1": attn, "kernel2_Q1": scores, "kernel5_Q1": gather,
            "driver_vs_batch": drivers, "phase_s": time.time() - t_phase}


# ---------------------------------------------------------------------------
# phase F: the raw-input chain (CAsT-19 ETL -> tokenize -> embed -> search)
# ---------------------------------------------------------------------------
PF_CAR, PF_MARCO, PF_DUPS, PF_TOPICS, PF_TURNS = 4096, 4096, 256, 20, 4


def write_raw_cast19(work):
    """Seeded raw CAsT-19 inputs in the formats the pre-port chain test
    writes: a TREC-CAR paragraphs CBOR (the port's ``encode_item``; a v2
    header item, ParaText and ParaLink bodies) of ``PF_CAR`` paragraphs, a
    MARCO tsv of ``PF_MARCO`` passages, ``PF_DUPS`` of them listed as
    duplicates of CAR paragraphs, the topic JSON and resolved TSV of
    ``PF_TOPICS`` conversations of ``PF_TURNS`` turns, and qrels naming CAR
    and MARCO ids (no dropped duplicate among them)."""
    rng = np.random.default_rng(17)
    cast = os.path.join(work, "cast")
    os.makedirs(cast)

    def words(lo, hi):
        return " ".join(rng.choice(DP_WORDS, int(rng.integers(lo, hi + 1))))

    car_ids = [f"{int(rng.integers(0, 1 << 62)):016x}{i:05d}" for i in range(PF_CAR)]
    with open(os.path.join(work, "car.cbor"), "wb") as f:
        f.write(encode_item([0, "header", [2, 0]]))
        for cid in car_ids:
            bodies = [[0, words(3, 40)]]
            if rng.random() < 0.5:
                bodies += [[1, "Page", "page-id", words(1, 3)], [0, words(2, 30)]]
            f.write(encode_item([1, cid, bodies]))
    with open(os.path.join(work, "marco.tsv"), "w") as f:
        for i in range(PF_MARCO):
            f.write(f"{i}\t{words(4, 80)}\n")
    dups = rng.choice(PF_MARCO, PF_DUPS, replace=False)
    with open(os.path.join(work, "dup.txt"), "w") as f:
        for j, d in enumerate(dups):
            f.write(f"CAR_{car_ids[j]}:MARCO_{d}\n")
    kept = np.setdiff1d(np.arange(PF_MARCO), dups)
    topics = []
    with open(os.path.join(cast, "evaluation_topics_annotated_resolved_v1.0.tsv"), "w") as fm, \
            open(os.path.join(cast, "2019qrels.txt"), "w") as fq:
        for t in range(PF_TOPICS):
            turns = []
            for n in range(1, PF_TURNS + 1):
                turns.append({"number": n, "raw_utterance": words(3, 10)})
                fm.write(f"{31 + t}_{n}\t{words(3, 10)}\n")
                for c in rng.choice(PF_CAR, 2, replace=False):
                    fq.write(f"{31 + t}_{n} 0 CAR_{car_ids[c]} {int(rng.integers(1, 3))}\n")
                fq.write(f"{31 + t}_{n} 0 MARCO_{int(rng.choice(kept))} 1\n")
            topics.append({"number": 31 + t, "title": words(1, 3), "description": "",
                           "turn": turns})
    with open(os.path.join(cast, "evaluation_topics_v1.0.json"), "w") as f:
        json.dump(topics, f)
    return cast


def sha256_of(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def raw_chain_path():
    """Phase F: raw CAsT-19 files -> ``python -m convdr_torch.etl.cast19``
    -> the tokenize driver -> ``gen_passage_embeddings`` (bf16) ->
    ``run_convdr_inference`` (exact f32) -> metrics, at full RoBERTa-base
    width. Held: CAR pids from 10,000,000 reach the run through
    offset2pid; the ETL's remapped qrels score the run (the driver's
    metrics recomputed from them; the run's top pid of every turn, written
    back as a CAR_/MARCO_ qrel and remapped through the ETL's id map, gives
    MRR 1); the run rank for rank an exact plain-PyTorch search of the same
    rows; kernels 1, 2 and 5 launched, counted from zero around the
    drivers."""
    t_phase = time.time()
    work = os.path.join(WORK, "raw_chain")
    os.makedirs(work)
    cast = write_raw_cast19(work)
    data, coll = os.path.join(work, "datasets"), os.path.join(work, "collections")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "convdr_torch.etl.cast19", "--car_cbor",
         os.path.join(work, "car.cbor"), "--msmarco_collection", os.path.join(work, "marco.tsv"),
         "--duplicate_file", os.path.join(work, "dup.txt"), "--cast_dir", cast,
         "--out_data_dir", data, "--out_collection_dir", coll],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    etl_s = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cast19 ETL failed:\n{proc.stdout}\n{proc.stderr}")
    digests = {os.path.relpath(os.path.join(d, name), work): sha256_of(os.path.join(d, name))
               for d in (coll, data) for name in sorted(os.listdir(d))}
    collection = os.path.join(coll, "collection.tsv")
    with open(collection) as f:
        n_coll = sum(1 for _ in f)
    if n_coll != PF_CAR + PF_MARCO - PF_DUPS or len(digests) != 12:
        raise AssertionError(f"ETL wrote {n_coll} passages, files {sorted(digests)}")
    os.symlink(collection, os.path.join(data, "collection.tsv"))
    processed = os.path.join(work, "processed")
    tok = tokenize_cli(collection, processed)
    if tok["tokenize"]["passages"] != n_coll or not tok["merge"]["identical"]:
        raise AssertionError(f"tokenize over the ETL collection: {tok}")
    emb_dir, trec = os.path.join(work, "embeddings"), os.path.join(work, "run.trec")
    argv = ["--model_path", "init", "--model_type", "rdot_nll",
            "--eval_file", os.path.join(data, "eval_topics.jsonl"),
            "--ann_data_dir", emb_dir, "--processed_data_dir", processed,
            "--raw_data_dir", data, "--qrels", os.path.join(data, "qrels.tsv"),
            "--output_trec_file", trec, "--output_query_type", "raw", "--query", "no_res",
            "--max_concat_length", str(SERVE_T), "--top_n", str(TOP_N)]
    for fn in (flash_attention, fused_scores_groupmax, dma_gather_groups):
        fn.launches = 0
    t0 = time.time()
    rows_written = gen_passage_embeddings.main([
        "--data_dir", processed, "--checkpoint", "init", "--model_type", "rdot_nll",
        "--output_dir", emb_dir, "--per_gpu_eval_batch_size", "64", "--dtype", "bfloat16"])
    t_embed = time.time() - t0
    t0 = time.time()
    metrics = run_convdr_inference.main(argv)
    torch.cuda.synchronize()
    t_infer = time.time() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches}
    if rows_written != n_coll or min(launches.values()) == 0:
        raise AssertionError(f"raw-input chain: {rows_written} rows, launches {launches}")

    run = parse_trec_run(trec)
    offset2pid = np.asarray(load_offset2pid(processed), np.int64)
    car_pids = offset2pid[offset2pid >= CAR_BASE_ID]
    in_run = np.array([pid for ranked in run.values() for pid, _ in ranked])
    if (sorted(car_pids.tolist()) != list(range(CAR_BASE_ID, CAR_BASE_ID + PF_CAR))
            or not (in_run >= CAR_BASE_ID).any() or not (in_run < PF_MARCO).any()
            or len(run) != PF_TOPICS * PF_TURNS):
        raise AssertionError("CAR pids from 10,000,000 do not reach the run")
    qrels = load_qrels(os.path.join(data, "qrels.tsv"))
    judged = {pid for rels in qrels.values() for pid in rels}
    recomputed = mean_metrics(evaluate_run(run, qrels, ndcg_cuts=(3,), recall_cuts=(TOP_N,)))
    if len(qrels) != len(run) or not judged <= set(offset2pid.tolist()) \
            or recomputed != metrics:
        raise AssertionError(f"the ETL's qrels do not score the run: {metrics} against "
                             f"{recomputed}")
    with open(os.path.join(coll, "car_idx_to_id.pickle"), "rb") as f:
        car_idx_to_id = pickle.load(f)
    with open(os.path.join(coll, "car_id_to_idx.pickle"), "rb") as f:
        car_id_to_idx = pickle.load(f)
    top_raw = os.path.join(work, "top1_qrels.txt")
    with open(top_raw, "w") as f:
        for qid, ranked in run.items():
            pid = ranked[0][0]
            raw_id = (car_idx_to_id[pid - CAR_BASE_ID] if pid >= CAR_BASE_ID
                      else f"MARCO_{pid}")
            f.write(f"{qid} 0 {raw_id} 1\n")
    remap_qrels(top_raw, top_raw + ".tsv", car_id_to_idx)
    top1 = mean_metrics(evaluate_run(run, load_qrels(top_raw + ".tsv"), recall_cuts=(TOP_N,)))
    if top1.get("mrr") != 1.0:
        raise AssertionError(f"the run's top pids do not survive the id remap: {top1}")

    args = run_convdr_inference.get_arguments(argv)
    qids, q_embs, _ = run_convdr_inference.encode_queries(
        args, args.model_path, args.eval_file, torch.float32, torch.device("cuda"))
    rows, offs = load_rows(emb_dir)
    row_pids = torch.from_numpy(offset2pid).cuda()[offs]
    q = torch.from_numpy(q_embs).cuda()
    top_s, top_i = stable_topk(q @ rows.T, TOP_N)
    ref_pids = row_pids[top_i].cpu().numpy()
    ref = {qid: list(zip(ref_pids[r].tolist(), top_s[r].tolist())) for r, qid in enumerate(qids)}
    equal, gap = ranks_match(run, ref, qids, q, rows, row_pids)
    out = {"etl_s": etl_s, "tokenize_s": tok["tokenize"]["seconds"], "embed_s": t_embed,
           "inference_s": t_infer, "passages": n_coll, "queries": len(qids),
           "metrics": metrics, "launches": launches, "ranks_equal": equal,
           "worst_gap_of_tol": gap, "sha256": digests, "phase_s": time.time() - t_phase}
    log(f"  python -m convdr_torch.etl.cast19: {PF_CAR} CAR paragraphs + {PF_MARCO} MARCO "
        f"passages - {PF_DUPS} duplicates = {n_coll} in {etl_s:.2f} s; tokenize "
        f"{out['tokenize_s']:.2f} s; embed (bf16) {t_embed:.2f} s; inference + exact f32 "
        f"search {t_infer:.2f} s; launches {launches}; CAR pids {CAR_BASE_ID}.. in the run; "
        f"metrics {metrics} (recomputed from the ETL qrels: equal; top-1 remap MRR 1.0); run "
        f"vs exact plain search: {equal}/{len(qids)} queries rank for rank, the others "
        f"near-ties (worst {gap:.3f} of the tolerance); phase {out['phase_s']:.1f} s")
    log("  sha256: " + ", ".join(f"{k} {v[:16]}" for k, v in digests.items()))
    return out


# ---------------------------------------------------------------------------
# phase P: --matmul_precision high / default
# ---------------------------------------------------------------------------
PRECISIONS = ("highest", "high", "default")
# |s - s_highest| / (|q| |p|) of each reduced precision: at most 2u + u^2 of
# sum |q_i p_i| <= |q| |p| (u the operands' unit roundoff: TF32 2^-10 even
# if its unit truncates, bf16 2^-8) plus both products' f32 accumulation
# (2 D 2^-24); and above 0 (the rounding happened)
PRECISION_BOUND = {"high": 2 * 2 ** -10 + 2 ** -20 + 2 * SEARCH_D * 2 ** -24,
                   "default": 2 * 2 ** -8 + 2 ** -16 + 2 * SEARCH_D * 2 ** -24}
# the least mean top-100 overlap with "highest" over the ~1.06M rows
OVERLAP_FLOOR = {"high": 0.99, "default": 0.95}
PRECISION_TURNS = 16


def top_overlap(i_a, i_b):
    """Mean over rows of |top-k of a & top-k of b| / k ([Q, k] ids)."""
    hit = (i_a[:, :, None] == i_b[:, None, :]).any(-1)
    return hit.float().mean().item()


def run_overlap(run_a, run_b):
    return float(np.mean([len({p for p, _ in run_a[q]} & {p for p, _ in run_b[q]})
                          / len(run_b[q]) for q in run_b]))


def precision_path(paths, q_embs):
    """Phase P over phase 3's rows (1,056,768 f32) and its 512 queries:
    ``flat_ip_topk`` at "highest", "high" and "default" (its time over one
    524,288-row block at Q=512, the product alone, the bf16 cast alone;
    the group maxima of its scores alone; the normalized score error
    against "highest", which must be above 0
    and within ``PRECISION_BOUND``; "default" within 1e-5 of |q| |p| of its
    plain emulation; the top-100 overlap with "highest" over all rows, at
    least ``OVERLAP_FLOOR``); ``run_convdr_inference --matmul_precision
    default`` end to end against phase 3's run; ``OnlineSearcher`` at
    "default" (every replay bit-equal to its eager program; overlap with
    the "highest" searcher's turns); then the "highest" search again, bit
    for bit the first (no TF32 leaked)."""
    t_phase = time.time()
    rows, _offs = load_rows(paths["emb_dir"])
    n = rows.shape[0]
    q = torch.from_numpy(q_embs).cuda()
    block = rows[N_PASSAGES:N_PASSAGES + SEARCH_N]  # one on-disk block
    norms = q.norm(dim=1)[:, None] * block.norm(dim=1)[None, :]
    s_ref = fused_scores_groupmax(q, block, GROUP)[0]
    smax = s_ref.abs().max().item()
    out, full = {}, {}
    for prec in PRECISIONS:
        res = {"topk_ms": cuda_ms(lambda: flat_ip_topk(q, block, TOP_N, block_rows=SEARCH_N,
                                                       precision=prec))}
        if prec == "highest":
            res["product_ms"] = cuda_ms(lambda: fused_scores_groupmax(q, block, GROUP))
        else:
            if prec == "default":
                res["cast_ms"] = cuda_ms(lambda: block.bfloat16())
                b16 = block.bfloat16()
                res["product_ms"] = cuda_ms(lambda: rounded_scores(q, b16, prec))
                del b16
            else:
                res["product_ms"] = cuda_ms(lambda: rounded_scores(q, block, prec))
            s = rounded_scores(q, block, prec)
            res["group_max_ms"] = cuda_ms(lambda: s.view(s.shape[0], -1, GROUP).amax(dim=-1))
            bit_equal = torch.equal(s, s_ref)
            d = (s - s_ref).abs()
            res["max_rel_err"] = (d / norms).max().item()
            res["max_err_over_max_score"] = d.max().item() / smax
            del d
            res["vs_plain_emulation"] = ((s - rounded_scores_plain(q, block, prec)).abs()
                                         / norms).max().item()
            del s
            if bit_equal or not 0.0 < res["max_rel_err"] <= PRECISION_BOUND[prec]:
                raise AssertionError(f"{prec}: bit-equal to highest {bit_equal}, normalized "
                                     f"error {res['max_rel_err']} (bound "
                                     f"{PRECISION_BOUND[prec]})")
            if prec == "default" and res["vs_plain_emulation"] > 1e-5:
                raise AssertionError(f"default against its plain emulation: "
                                     f"{res['vs_plain_emulation']}")
        full[prec] = flat_ip_topk(q, rows, TOP_N, block_rows=SEARCH_N, valid_rows=n,
                                  precision=prec)
        if prec != "highest":
            res["top100_overlap"] = top_overlap(full[prec][1], full["highest"][1])
            if res["top100_overlap"] < OVERLAP_FLOOR[prec]:
                raise AssertionError(f"{prec}: top-{TOP_N} overlap {res['top100_overlap']}")
        out[prec] = res
        torch.cuda.empty_cache()
    del norms, s_ref
    log(f"  flat_ip_topk at Q={SEARCH_Q} over one {SEARCH_N}-row block (ms: top-{TOP_N}, "
        "product alone; normalized error; top-100 overlap over all rows): "
        + "; ".join(f"{p} {r['topk_ms']:.3f}, {r['product_ms']:.3f}"
                    + (f" (+ bf16 cast {r['cast_ms']:.3f})" if "cast_ms" in r else "")
                    + (f", group max {r['group_max_ms']:.3f}" if "group_max_ms" in r else "")
                    + (f", err {r['max_rel_err']:.3e} (of the max score "
                       f"{r['max_err_over_max_score']:.3e}; against its plain emulation "
                       f"{r['vs_plain_emulation']:.3e}), overlap {r['top100_overlap']:.4f}"
                       if p != "highest" else "")
                    for p, r in out.items()))

    # the batch driver at "default", against phase 3's run
    for fn in (flash_attention, fused_scores_groupmax, dma_gather_groups):
        fn.launches = 0
    t0 = time.time()
    run_convdr_inference.main(
        inference_argv(WORK, paths["processed"], paths["raw"], paths["emb_dir"], "run_default")
        + ["--matmul_precision", "default"])
    torch.cuda.synchronize()
    driver_s = time.time() - t0
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_scores_groupmax": fused_scores_groupmax.launches,
                "dma_gather_groups": dma_gather_groups.launches}
    overlap = run_overlap(parse_trec_run(os.path.join(WORK, "run_default.trec")),
                          parse_trec_run(paths["trec"]))
    if (launches["fused_scores_groupmax"] or not launches["dma_gather_groups"]
            or not launches["flash_attention_fwd"] or overlap < OVERLAP_FLOOR["default"]):
        raise AssertionError(f"--matmul_precision default: launches {launches}, overlap "
                             f"{overlap}")
    out["driver_default"] = {"inference_s": driver_s, "launches": launches,
                             "top100_overlap": overlap}
    log(f"  run_convdr_inference --matmul_precision default: {driver_s:.2f} s, launches "
        f"{launches}, top-{TOP_N} overlap with phase 3's run {overlap:.4f}")

    # online serving at "default" against "highest"
    histories = make_histories(PRECISION_TURNS)
    served = {}
    for prec in ("highest", "default"):
        for fn in COUNTED_KERNELS.values():
            fn.launches = 0
        searcher = OnlineSearcher.from_blocks(None, paths["emb_dir"], model_type="rdot_nll",
                                              top_n=TOP_N, max_concat_length=SERVE_T,
                                              precision=prec)
        searcher.warmup()
        turns = []
        for h in histories:
            got = searcher.search(h)
            ids, mask = history_to_inputs(searcher.tokenizer, h, max_concat_length=SERVE_T)
            s, i = searcher.program(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda())
            if not same_bits(got, (s.cpu().numpy(), searcher.rows_to_offsets(i.cpu().numpy()))):
                raise AssertionError(f"serving at {prec}: a replay differs from the eager program")
            turns.append(got[1][0])
        g = searcher.graphs[1]
        served[prec] = {"rows": torch.from_numpy(np.stack(turns)),
                        "search": latency_ms(searcher.stats.latencies),
                        "launches_per_replay": dict(g.launches), "replays": g.replays,
                        "replay_device_ms": cuda_ms(g.graph.replay, iters=20)}
        del searcher, g
        torch.cuda.empty_cache()
    d = served["default"]
    serve_overlap = top_overlap(d["rows"], served["highest"]["rows"])
    if (d["launches_per_replay"]["fused_scores_groupmax"]
            or not d["launches_per_replay"]["dma_gather_groups"]
            or serve_overlap < OVERLAP_FLOOR["default"]):
        raise AssertionError(f"serving at default: {d['launches_per_replay']}, overlap "
                             f"{serve_overlap}")
    out["serving"] = {p: {k: v for k, v in r.items() if k != "rows"} for p, r in served.items()}
    out["serving"]["default"]["top100_overlap"] = serve_overlap
    log(f"  OnlineSearcher, {PRECISION_TURNS} turns a precision, every replay bit-equal to "
        f"its eager program: search p50 highest {served['highest']['search']['p50_ms']:.3f} "
        f"ms, default {d['search']['p50_ms']:.3f} ms; replay on the device "
        f"{served['highest']['replay_device_ms']:.3f} / {d['replay_device_ms']:.3f} ms; "
        f"top-{TOP_N} overlap {serve_overlap:.4f}; launches a replay at default "
        f"{d['launches_per_replay']}")

    again = flat_ip_topk(q, rows, TOP_N, block_rows=SEARCH_N, valid_rows=n)
    if not (torch.equal(again[0], full["highest"][0]) and torch.equal(again[1], full["highest"][1])
            and torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("a highest search after high / default is not bit-equal to the "
                             "first: TF32 leaked")
    out["highest_again_bit_equal"] = True
    out["phase_s"] = time.time() - t_phase
    log(f"  the highest search again: bit-equal to the first; phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase C: multi-GPU at world size 1 (the card holds one NCCL rank)
# ---------------------------------------------------------------------------
# a torchrun rank's program: one driver's main, then the meshes it formed
# (axis names, backend) and the kernels' counts
RANK_CODE = r"""
import importlib, json, sys
import torch.distributed as dist
from convdr_torch.models.attention import flash_attention
from convdr_torch.ops.fused_search import fused_scores_groupmax
from convdr_torch.ops.gather_groups import dma_gather_groups
from convdr_torch.parallel import mesh
meshes, real = [], mesh.get_mesh
def get_mesh(*args, **kwargs):
    m = real(*args, **kwargs)
    meshes.append([list(m.mesh_dim_names), dist.get_backend(), dist.get_world_size()])
    return m
mesh.get_mesh = get_mesh
importlib.import_module("convdr_torch.drivers." + sys.argv[1]).main(sys.argv[2:])
print("MESHES " + json.dumps(meshes))
print("LAUNCHES " + json.dumps({"flash_attention_fwd": flash_attention.launches,
                                "fused_scores_groupmax": fused_scores_groupmax.launches,
                                "dma_gather_groups": dma_gather_groups.launches}))
"""
COUNTED = ("flash_attention_fwd", "flash_attention_bwd", "fused_scores_groupmax",
           "dma_gather_groups")


def zero_counts():
    flash_attention.launches = flash_attention_bwd.launches = 0
    fused_scores_groupmax.launches = dma_gather_groups.launches = 0


def read_counts():
    return dict(zip(COUNTED, (flash_attention.launches, flash_attention_bwd.launches,
                              fused_scores_groupmax.launches, dma_gather_groups.launches)))


def torchrun_driver(module, argv, name, axis):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1``
    over one driver (its ``WORLD_SIZE`` makes it form its mesh over an NCCL
    group, checked: one ``(axis,)`` mesh on NCCL at world size 1); returns
    the rank's kernel counts and the wall seconds."""
    log_path = os.path.join(WORK, f"{name}.log")
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.time()
    with open(log_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", "--no_python", sys.executable, "-c", RANK_CODE, module, *argv],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT, timeout=300)
    seconds = time.time() - t0
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} exited {proc.returncode}:\n{text[-4000:]}")
    meshes = json.loads(text.split("MESHES ", 1)[1].splitlines()[0])
    if meshes != [[[axis], "nccl", 1]]:
        raise AssertionError(f"torchrun {module} formed {meshes}, not one ({axis!r},) NCCL mesh")
    counts = json.loads(text.split("LAUNCHES ", 1)[1].splitlines()[0])
    return counts, seconds


def sharded_search_checks(gen):
    """The world-1 NCCL sharded search and the in-process S-shard
    emulation over one 524,288-row block at Q=512, f32 and int8, against
    the unsharded ``flat_ip_topk``. Returns the results and, for the
    timing, each dtype's operands and unsharded result."""
    from convdr_torch.parallel.mesh import get_mesh, shard_rows
    from convdr_torch.parallel.sharded_search import (
        local_flat_ip_topk,
        merge_shard_topk,
        sharded_flat_ip_topk,
    )

    q32 = torch.randn(SEARCH_Q, SEARCH_D, generator=gen, device="cuda")
    p32 = torch.randn(SEARCH_N, SEARCH_D, generator=gen, device="cuda")
    mesh = get_mesh(("index",))
    out, operands = {}, {}
    for dtype in (torch.float32, torch.int8):
        q, p = search_operands(q32, p32, dtype)
        want_s, want_i = flat_ip_topk(q, p, TOP_N)
        got_s, got_i = sharded_flat_ip_topk(mesh, q, p, TOP_N)
        row = {"world1_equal": bool(torch.equal(got_i, want_i) and torch.equal(got_s, want_s))}
        for n_shards in (4, 3):  # 3: a short last shard
            parts = []
            for shard_id in range(n_shards):
                lo, hi, rows = shard_rows(SEARCH_N, n_shards, shard_id, ROW_TILE)
                shard = torch.zeros((rows, SEARCH_D), dtype=p.dtype, device="cuda")
                shard[: hi - lo] = p[lo:hi]
                parts.append(local_flat_ip_topk(q, shard, TOP_N, shard_id, n_shards,
                                                valid_rows=SEARCH_N))
                del shard
            s, i = merge_shard_topk(torch.stack([a for a, _ in parts]),
                                    torch.stack([b for _, b in parts]), TOP_N)
            row[f"S{n_shards}_equal"] = bool(torch.equal(i, want_i) and torch.equal(s, want_s))
        out[dtype_name(dtype)] = row
        log(f"  {dtype_name(dtype)}: world-1 NCCL sharded search == flat_ip_topk "
            f"{row['world1_equal']}; S=4 / S=3 emulation == unsharded {row['S4_equal']} / "
            f"{row['S3_equal']}")
        if not (row["world1_equal"] and row["S4_equal"] and row["S3_equal"]):
            raise AssertionError(f"sharded search differs from flat_ip_topk ({dtype}): {row}")
        operands[dtype_name(dtype)] = (q, p, want_s, want_i)
        del got_s, got_i, parts
    del q32, p32
    return out, operands


def time_sharded_search(out, operands):
    """CUDA-event times of the world-1 sharded search, the unsharded one
    and the NCCL all-gather of the [1, Q, k] lists (f32 scores, int64 ids)."""
    from convdr_torch.parallel.mesh import all_gather_rows, get_mesh
    from convdr_torch.parallel.sharded_search import sharded_flat_ip_topk

    mesh = get_mesh(("index",))
    for name, (q, p, want_s, want_i) in operands.items():
        row = out[name]
        for _ in range(2):  # in turns: sharded, unsharded, unsharded, sharded
            row.setdefault("sharded_ms", []).append(
                cuda_ms(lambda: sharded_flat_ip_topk(mesh, q, p, TOP_N), iters=5))
            row.setdefault("unsharded_ms", []).insert(
                0, cuda_ms(lambda: flat_ip_topk(q, p, TOP_N), iters=5))
        row["all_gather_ms"] = cuda_ms(lambda: (all_gather_rows(mesh, "index", want_s),
                                                all_gather_rows(mesh, "index", want_i)), iters=50)
        log(f"  {name}: sharded search {row['sharded_ms']} ms, unsharded "
            f"{row['unsharded_ms']} ms; all_gather of the [1, {SEARCH_Q}, {TOP_N}] lists "
            f"(f32 scores + int64 ids) {row['all_gather_ms']:.4f} ms")
    operands.clear()
    torch.cuda.empty_cache()


def dp_step_check():
    """Phase 4's full-width step (the kernels, seeds 42 / 0, the seeded
    batch) without a mesh and over the world-1 NCCL ``("data",)`` mesh: the
    same losses and gradients, bit for bit."""
    from convdr_torch.parallel.mesh import get_mesh

    device = torch.device("cuda")
    student, teacher = (load_model_and_params("rdot_nll", "init", device=device, seed=seed)[2]
                        for seed in (42, 0))
    teacher.requires_grad_(False)
    init = {n: p.detach().clone() for n, p in student.state_dict().items()}
    batch = train_step_batch(np.random.default_rng(2))
    config = TrainConfig(ranking_task=True, num_negatives=TRAIN_NEG)
    results = []
    for mesh in (None, get_mesh(("data",))):
        student.load_state_dict(init)
        state, tx = create_train_state(student, config, 10)
        _, metrics = make_train_step(student, teacher, tx, config, mesh=mesh)(state, batch)
        results.append(({n: float(v) for n, v in metrics.items()},
                        {n: p.grad.detach().clone() for n, p in student.named_parameters()}))
        del state, tx
    (m0, g0), (m1, g1) = results
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    log(f"  DP step on the world-1 mesh against the unmeshed step: metrics equal {m0 == m1} "
        f"({m1}), {len(g0) - len(differ)}/{len(g0)} gradients bit-identical")
    if m0 != m1 or differ:
        raise AssertionError(f"the world-1 DP step differs: {m0} vs {m1}; {differ[:5]}")
    del student, teacher, init, results
    torch.cuda.empty_cache()
    return {"metrics": m1, "gradients": len(g0), "bit_identical": True}


def multi_gpu_path(paths, gen):
    """Phase C: the meshed drivers under torchrun (one NCCL rank) against
    phase 3's unmeshed ones, the world-1 NCCL sharded search and the S=4 /
    S=3 emulation against the unsharded search, and one DP train step on
    a world-1 mesh against the unmeshed step."""
    from convdr_torch.parallel.dryrun import single_rank

    t_phase = time.time()
    processed, raw, emb_dir = paths["processed"], paths["raw"], paths["emb_dir"]
    emb_mesh = os.path.join(WORK, "embeddings_mesh")
    embed_counts, embed_s = torchrun_driver("gen_passage_embeddings", [
        "--data_dir", processed, "--checkpoint", "init", "--model_type", "rdot_nll",
        "--output_dir", emb_mesh, "--per_gpu_eval_batch_size", "64",
        "--dtype", "bfloat16", "--num_blocks", "1"], "torchrun_embed", "data")
    (rows, offs), (want_rows, want_offs) = (
        next(iter_embedding_blocks(d, max_blocks=1))[1:] for d in (emb_mesh, emb_dir))
    embed_err = float(np.abs(rows - want_rows).max()) if rows.shape == want_rows.shape else None
    log(f"  torchrun gen_passage_embeddings ({embed_s:.1f} s): block 0 {rows.shape}, offsets "
        f"equal {np.array_equal(offs, want_offs)}, rows max abs diff {embed_err} (tolerance 1e-5)")
    if not np.array_equal(offs, want_offs) or embed_err is None or embed_err > 1e-5:
        raise AssertionError("the meshed embed's block differs from phase 3's")
    infer_counts, infer_s = torchrun_driver(
        "run_convdr_inference", inference_argv(WORK, processed, raw, emb_dir, "run_mesh"),
        "torchrun_infer", "index")
    with open(paths["trec"], "rb") as a, open(os.path.join(WORK, "run_mesh.trec"), "rb") as b:
        trec_equal = a.read() == b.read()
    log(f"  torchrun run_convdr_inference ({infer_s:.1f} s): TREC run byte-identical to phase "
        f"3's {trec_equal}")
    if not trec_equal:
        raise AssertionError("the meshed inference's TREC run differs from phase 3's")
    with single_rank(no_cuda=False):
        zero_counts()
        search, operands = sharded_search_checks(gen)
        step = dp_step_check()
        counts = read_counts()
        time_sharded_search(search, operands)
    for k, v in (*embed_counts.items(), *infer_counts.items()):
        counts[k] += v
    log(f"  phase C launches (both torchrun ranks and this process): {counts}")
    if any(v <= 0 for v in counts.values()):
        raise AssertionError(f"phase C did not run through its kernels: {counts}")
    return {"launches": counts, "embed_s": embed_s, "inference_s": infer_s,
            "embed_max_abs_diff": embed_err, "trec_byte_identical": trec_equal,
            "search": search, "dp_step": step, "phase_s": time.time() - t_phase}


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
        log("phase F, the raw-input chain (raw CAsT-19 files -> python -m "
            "convdr_torch.etl.cast19 -> tokenize -> bf16 embed -> exact f32 search; full "
            "RoBERTa-base width):")
        raw_chain = raw_chain_path()
        torch.cuda.empty_cache()
        log("phase P, --matmul_precision highest / high / default over the inference "
            "path's rows:")
        precision = precision_path(paths, q_embs)
        torch.cuda.empty_cache()
        # the backward's checks come after the inference path, which then
        # runs in the same device-memory state as before training existed
        log("backward kernel check against its plain version:")
        kernels.append(time_attention_bwd(gen, check_attention_bwd(gen)))
        torch.cuda.empty_cache()
        log("training path (full RoBERTa-base width, seeded weights, f32):")
        step_check = check_train_step()
        train_launches, train = train_path()
        torch.cuda.empty_cache()
        log("phase O, the JAX package's orbax checkpoints (the committed fixture; a "
            "full-width TrainState round trip; inference and --resume from orbax dirs):")
        orbax = orbax_path(paths, smi)
        torch.cuda.empty_cache()
        log("bf16 training (kernel 1 with its lse and kernel 1b in bf16, f32 master weights; "
            "full RoBERTa-base width), then dropout:")
        bf16 = bf16_training_path(gen)
        torch.cuda.empty_cache()
        log("data plane (raw collection -> tokenize driver -> bf16 .cnb blocks -> traced "
            "search; full RoBERTa-base width):")
        t0 = time.time()
        data_plane = data_plane_path(paths, qids, q_embs)
        data_plane["phase_s"] = time.time() - t0
        torch.cuda.empty_cache()
        log("rehearsal (convdr_torch.scripts.rehearsal --smoke on the card):")
        t0 = time.time()
        rehearsed = rehearsal_path()
        rehearsed["phase_s"] = time.time() - t0
        torch.cuda.empty_cache()
        log("the ANN family (k-means, IVF, PQ/OPQ, IVFPQ, refine; D=768, 1M rows) and "
            "the build_ivf_index -> --ivf_dir drivers:")
        ann = ann_path(paths, metrics, qids, q_embs)
        torch.cuda.empty_cache()
        log("online serving (one captured CUDA graph a turn; full RoBERTa-base width, "
            "seeded weights; flat f32 / bf16 / int8, IVF int8, IVFPQ pq4):")
        serving = serving_path(paths)
        torch.cuda.empty_cache()
        log("phase C, multi-GPU at world size 1 (torchrun with one NCCL rank; the sharded "
            "search and its S-shard emulation; a data-parallel step):")
        multi = multi_gpu_path(paths, gen)
        log(f"phase F {raw_chain['phase_s']:.1f} s, phase P {precision['phase_s']:.1f} s, "
            f"phase O {orbax['phase_s']:.1f} s, "
            f"bf16 training phase {bf16['phase_s']:.1f} s, "
            f"data plane phase {data_plane['phase_s']:.1f} s, rehearsal phase "
            f"{rehearsed['phase_s']:.1f} s, ANN phase {ann['phase_s']:.1f} s, serving phase "
            f"{serving['phase_s']:.1f} s, phase C {multi['phase_s']:.1f} s")
        f32 = multi["search"]["float32"]
        log(f"phase C on {smi}: NCCL all_gather of the [1, {SEARCH_Q}, {TOP_N}] lists "
            f"{f32['all_gather_ms']:.4f} ms; sharded search {f32['sharded_ms']} ms against "
            f"unsharded {f32['unsharded_ms']} ms (f32, Q={SEARCH_Q}, N={SEARCH_N}); "
            f"torchrun embed {multi['embed_s']:.1f} s, inference {multi['inference_s']:.1f} s; "
            f"phase {multi['phase_s']:.1f} s")
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
    # the later slices' paths, each counted from zero around its own run
    fwd["launches_by_path"].update(data_plane=data_plane["launches"]["flash_attention_fwd"],
                                   rehearsal=rehearsed["launches"]["flash_attention_fwd"],
                                   ann_ivf_driver=ann["flash_attention_launches"])
    search["launches_by_path"].update(
        data_plane_bf16=data_plane["launches"]["fused_scores_groupmax"],
        rehearsal=rehearsed["launches"]["fused_scores_groupmax"])
    k5["launches_by_path"] = {"inference": launches["dma_gather_groups"],
                              "data_plane": data_plane["launches"]["dma_gather_groups"],
                              "rehearsal": rehearsed["launches"]["dma_gather_groups"]}
    bwd["launches_by_path"] = {"train": train_launches["flash_attention_bwd"],
                               "rehearsal": rehearsed["launches"]["flash_attention_bwd"]}
    # phase O: the orbax checkpoints' steps, inference and resumes
    for entry, kernel in ((fwd, "flash_attention_fwd"), (bwd, "flash_attention_bwd"),
                          (search, "fused_scores_groupmax"), (k5, "dma_gather_groups")):
        entry["launches_by_path"]["orbax"] = orbax["launches"][kernel]
    # the serving phase's replays: each graph's recorded launches x its
    # replays, plus the eager warm-up before its capture
    for backend, b in serving["backends"].items():
        for entry, kernel in ((fwd, "flash_attention_fwd"), (search, "fused_scores_groupmax"),
                              (k5, "dma_gather_groups")):
            if b["launches"][kernel]:
                entry["launches_by_path"][f"serving_{backend}"] = b["launches"][kernel]
    # phase 4f's bf16 rows, counted on the bf16 training path
    for entry, source in zip(bf16["kernels"], ("flash_attention", "flash_attention_bwd")):
        entry["ptxas"] = ptxas_summary(source)
    kernels.extend(bf16["kernels"])
    # phase C: the torchrun ranks' and this process's launches
    for entry, kernel in ((fwd, "flash_attention_fwd"), (bwd, "flash_attention_bwd"),
                          (search, "fused_scores_groupmax"), (k5, "dma_gather_groups")):
        entry["launches_by_path"]["multi_gpu_world1"] = multi["launches"][kernel]
    # phases F and P: the raw-input chain, and the "default" driver and
    # searcher (kernel 2 does not run at "default": the product is cuBLAS's)
    default_serving = precision["serving"]["default"]
    fwd["launches_by_path"].update(
        raw_input_chain=raw_chain["launches"]["flash_attention_fwd"],
        precision_default_driver=precision["driver_default"]["launches"]["flash_attention_fwd"],
        precision_default_serving=default_serving["launches_per_replay"]["flash_attention_fwd"]
        * default_serving["replays"])
    search["launches_by_path"]["raw_input_chain"] = raw_chain["launches"]["fused_scores_groupmax"]
    k5["launches_by_path"].update(
        raw_input_chain=raw_chain["launches"]["dma_gather_groups"],
        precision_default_driver=precision["driver_default"]["launches"]["dma_gather_groups"],
        precision_default_serving=default_serving["launches_per_replay"]["dma_gather_groups"]
        * default_serving["replays"])
    fwd["serving_B1"] = serving["kernel1_B1"]
    search["serving_Q1"] = serving["kernel2_Q1"]
    k5["serving_Q1"] = serving["kernel5_Q1"]
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
    bf16_train, bf16_phases = bf16["train"], bf16["train_step_check"]["phases_ms"]
    log(f"bf16 training: {bf16_train['ms_per_step']:.1f} ms/step, "
        f"{bf16_train['examples_per_s']:.1f} examples/s; the step's device parts "
        f"{sum(bf16_phases.values()):.1f} ms ({', '.join(f'{n} {v:.1f}' for n, v in bf16_phases.items())})")
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its path")
    log(f"chip_smoke total {time.time() - t_start:.1f} s")
    result = {"kernels": kernels}
    log(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": smi, "metrics": metrics, "embed_s": t_embed,
                       "inference_s": t_infer, "int8": int8, "streaming_phase_s": t_stream,
                       "launch_configs": configs,
                       "train": train, "train_step_check": step_check, "bf16_training": bf16,
                       "raw_input_chain": raw_chain, "precision": precision,
                       "data_plane": data_plane, "rehearsal": rehearsed, "ann": ann,
                       "serving": serving, "multi_gpu": multi, "orbax": orbax,
                       "total_s": time.time() - t_start}, f, indent=1)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
