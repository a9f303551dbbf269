"""Multi-GPU check over N ranks of one host: the sharded exact search, the
all-gather of its lists and a data-parallel KD + ranking step, each held
to one card's result and timed beside it.

    torchrun --standalone --nproc_per_node 4 -m convdr_torch.scripts.multi_gpu_check
    torchrun --standalone --nproc_per_node 4 -m convdr_torch.scripts.multi_gpu_check \\
        --no_cuda --rows 8192 --dim 96 --arch_size tiny   # gloo on the CPU, a rehearsal

Every rank makes the same seeded inputs. The search: 512 queries over
``--rows`` rows (default 1,048,576, D=768), f32 and int8, each rank holding
its contiguous shard, against ``flat_ip_topk`` over all rows on rank 0's
card (``torch.equal``, scores and indices); times of the sharded search, of
a rank's local search alone and of the all-gather of the [S, 512, 100]
lists (f32 scores, int64 ids), against the unsharded search on one card.
The step: RoBERTa-base ``rdot_nll`` at random weights from seeds, 4
examples a rank with 9 negatives (concat 256, documents up to 512),
against the single-process step on the global batch on rank 0's card
(loss and each gradient's largest difference over its largest entry, the
key biases' over their key weights');
each step's time. The training loop: ``run_convdr_train`` for
``LOOP_STEPS`` steps over every rank on a synthetic CAsT-shaped train file
(each rank building only its rows), against the driver without a mesh on
rank 0 over the global batch: the losses and the ms a step, host batch
build included. Rank 0 prints the card's name and power limit and, last,
one JSON line; ``--out`` writes it to a file too. It exits non-zero when
the sharded search differs from one card's, when a DP loss or the grad
norm (the loop's first loss too) is more than ``METRIC_RTOL`` from the
single-process step's, or when
a gradient differs by more than ``GRAD_OF_SCALE`` of its scale: two f32
steps of the same batch differ there by a few 1e-3 (f32 attention
gradients read up to ~3e-3 of scale against f64), while a gradient summed
but not divided over S ranks is off by S - 1 of its scale.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from convdr_torch.core.config import TrainConfig
from convdr_torch.core.loading import load_model_and_params
from convdr_torch.ops.exact_search import flat_ip_topk
from convdr_torch.ops.quant import Int8Quantizer, quantize_passages_dev
from convdr_torch.parallel.mesh import (
    all_gather_rows,
    axis_index,
    get_mesh,
    init_distributed,
    shard_batch,
    shard_rows,
)
from convdr_torch.parallel.sharded_search import local_flat_ip_topk, sharded_flat_ip_topk
from convdr_torch.train.trainer import create_train_state, make_train_step

QUERIES, TOP_N, ITERS = 512, 100, 10
LOOP_STEPS = 8
METRIC_RTOL, GRAD_OF_SCALE = 1e-5, 1e-2
BATCH, NEGATIVES, CONCAT_T, TARGET_T, DOC_T = 4, 9, 256, 64, 512


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--dim", type=int, default=768)
    parser.add_argument("--arch_size", default="base", choices=["base", "tiny"])
    parser.add_argument("--no_cuda", action="store_true",
                        help="gloo ranks on the CPU (a rehearsal; times are the CPU's)")
    parser.add_argument("--out", default="", help="rank 0 also writes the JSON here")
    return parser.parse_args(argv)


def timed_ms(fn, device, iters):
    """Mean ms of ``fn()`` after a warm-up, every rank in step: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    dist.barrier()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def search_check(args, device, mesh, main):
    n_shards, shard_id = dist.get_world_size(), axis_index(mesh, "index")
    gen = torch.Generator(device=device).manual_seed(0)
    q32 = torch.randn(QUERIES, args.dim, generator=gen, device=device)
    p32 = torch.randn(args.rows, args.dim, generator=gen, device=device)
    lo, hi, rows = shard_rows(args.rows, n_shards, shard_id)
    out = {}
    for name in ("float32", "int8"):
        q, p = q32, p32
        if name == "int8":
            quant = Int8Quantizer.fit(p32[:65536].cpu().numpy())
            p = quantize_passages_dev(p32, torch.from_numpy(quant.scales).to(device))
            q = torch.from_numpy(quant.quantize_queries(q32.cpu().numpy())[0]).to(device)
        shard = torch.zeros((rows, args.dim), dtype=p.dtype, device=device)
        shard[: hi - lo] = p[lo:hi]
        got_s, got_i = sharded_flat_ip_topk(mesh, q, shard, TOP_N, valid_rows=args.rows)
        row = {
            "sharded_ms": timed_ms(
                lambda: sharded_flat_ip_topk(mesh, q, shard, TOP_N, valid_rows=args.rows),
                device, ITERS),
            "local_ms": timed_ms(
                lambda: local_flat_ip_topk(q, shard, TOP_N, shard_id, n_shards,
                                           valid_rows=args.rows), device, ITERS),
            "all_gather_ms": timed_ms(
                lambda: (all_gather_rows(mesh, "index", got_s),
                         all_gather_rows(mesh, "index", got_i)), device, 5 * ITERS),
        }
        if main:
            want_s, want_i = flat_ip_topk(q, p, TOP_N)
            row["equal"] = bool(torch.equal(got_i, want_i) and torch.equal(got_s, want_s))
        # the unsharded search on rank 0's card alone, the others idle
        unsharded_ms = timed_ms((lambda: flat_ip_topk(q, p, TOP_N)) if main else (lambda: None),
                                device, ITERS)
        if main:
            row["unsharded_ms"] = unsharded_ms
        out[name] = row
        del shard, q, p
    return out


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


def train_batch(rows, vocab, capacity, rng):
    """A seeded batch of ragged rows; lengths cut to the position table."""
    k = NEGATIVES + 1
    concat_t, target_t, doc_t = (min(t, capacity) for t in (CONCAT_T, TARGET_T, DOC_T))

    def ragged(n, t, lo):
        return (np.arange(t)[None, :] < rng.integers(lo, t + 1, n)[:, None]).astype(np.int32)

    cmask, tmask = ragged(rows, concat_t, 16), ragged(rows, target_t, 4)
    dmask = ragged(rows * k, doc_t, 32).reshape(rows, k, doc_t)
    return {
        "concat_ids": rng.integers(3, vocab, (rows, concat_t)) * cmask + (1 - cmask),
        "concat_mask": cmask,
        "target_ids": rng.integers(3, vocab, (rows, target_t)) * tmask + (1 - tmask),
        "target_mask": tmask,
        "doc_ids": rng.integers(3, vocab, (rows, k, doc_t)) * dmask + (1 - dmask),
        "doc_mask": dmask,
    }


def step_check(args, device, main):
    """The DP step over all ranks on the global batch, and on rank 0 the
    single-process step on the same batch from the same weights."""
    mesh = get_mesh(("data",))
    preset = "tiny" if args.arch_size == "tiny" else None
    (cfg, _, student), (_, _, teacher) = (
        load_model_and_params("rdot_nll", "init", device=device, seed=seed, arch_preset=preset)
        for seed in (42, 0))
    teacher.requires_grad_(False)
    init = {n: p.detach().clone() for n, p in student.state_dict().items()}
    batch = {n: torch.from_numpy(a.astype(np.int32)).to(device) for n, a in train_batch(
        BATCH * dist.get_world_size(), cfg.arch.vocab_size,
        cfg.arch.max_position_embeddings - cfg.arch.position_offset,
        np.random.default_rng(2)).items()}
    config = TrainConfig(ranking_task=True, num_negatives=NEGATIVES)

    def run(step_mesh):
        student.load_state_dict(init)
        state, tx = create_train_state(student, config, 10)
        step = make_train_step(student, teacher, tx, config, mesh=step_mesh)
        rows = batch if step_mesh is None else shard_batch(step_mesh, batch)
        _, metrics = step(state, rows)
        grads = {n: p.grad.detach().clone() for n, p in student.named_parameters()}
        ms = []
        for _ in range(3):  # later steps on the moved weights, for the time
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, rows)
            if device.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return {n: float(v) for n, v in metrics.items()}, grads, ms

    dp_metrics, dp_grads, dp_ms = run(mesh)
    out = {"global_batch": BATCH * dist.get_world_size(), "dp": dp_metrics, "dp_step_ms": dp_ms}
    if main:
        metrics, grads, ms = run(None)
        # a gradient's difference over its largest entry; the key biases'
        # gradient is zero in exact arithmetic (softmax shift invariance),
        # so theirs is over their layer's key-weight gradient's
        worst = max(((dp_grads[n] - g).abs().max().item()
                     / grads[n.replace("key.bias", "key.weight")].abs().max().item(), n)
                    for n, g in grads.items())
        out.update(single=metrics, single_step_ms=ms,
                   worst_grad_diff_of_scale={"value": worst[0], "leaf": worst[1]})
    dist.barrier()
    return out


def loop_check(args, device, main):
    """``run_convdr_train`` over every rank (``BATCH`` examples a rank,
    each rank tokenizing and uploading only its rows) and, on rank 0
    alone, without a mesh on the global batch: the logged losses and the
    steady ms a step (metrics.jsonl's intervals after step 2)."""
    from convdr_torch.drivers import run_convdr_train

    work = [tempfile.mkdtemp(prefix="convdr_dp_") if main else None]
    dist.broadcast_object_list(work, src=0)
    work = work[0]
    if main:
        make_train_file(os.path.join(work, "train.jsonl"))
    dist.barrier()
    argv = ["--train_file", os.path.join(work, "train.jsonl"), "--model_type", "rdot_nll",
            "--model_name_or_path", "init", "--query", "no_res", "--ranking_task",
            "--num_negatives", str(NEGATIVES), "--max_concat_length", str(CONCAT_T),
            "--max_doc_length", str(DOC_T), "--learning_rate", "1e-5",
            "--max_steps", str(LOOP_STEPS), "--arch_size", args.arch_size,
            *(["--no_cuda"] if args.no_cuda else [])]

    def logged(out_dir):
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        times = [r["time"] for r in rows]
        return [r["loss"] for r in rows], 1e3 * float(np.mean(np.diff(times[1:])))

    s = dist.get_world_size()
    run_convdr_train.main(argv + ["--output_dir", os.path.join(work, "dp"),
                                  "--per_gpu_train_batch_size", str(BATCH)])
    dist.barrier()
    out = {"global_batch": BATCH * s, "steps": LOOP_STEPS}
    if main:
        run_convdr_train.main(argv + ["--output_dir", os.path.join(work, "one"), "--no_mesh",
                                      "--per_gpu_train_batch_size", str(BATCH * s)])
        (dp_losses, dp_ms), (losses, ms) = logged(os.path.join(work, "dp")), logged(
            os.path.join(work, "one"))
        out.update(dp_losses=dp_losses, dp_step_ms=dp_ms, single_losses=losses,
                   single_step_ms=ms, worst_loss_rel_diff=max(
                       abs(a - b) / abs(b) for a, b in zip(dp_losses, losses)))
        shutil.rmtree(work)
    dist.barrier()
    return out


def main(argv=None):
    args = get_arguments(argv)
    device = init_distributed(args.no_cuda)
    try:
        main_rank = dist.get_rank() == 0
        mesh = get_mesh(("index",))
        result = {"world_size": dist.get_world_size(), "backend": dist.get_backend(),
                  "rows": args.rows, "search": search_check(args, device, mesh, main_rank)}
        result["step"] = step_check(args, device, main_rank)
        result["loop"] = loop_check(args, device, main_rank)
    finally:
        dist.destroy_process_group()
    if not main_rank:
        return None
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
        result["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    failed = [f"search {n}" for n, r in result["search"].items() if not r["equal"]]
    step = result["step"]
    failed += [f"step {n}" for n, v in step["single"].items()
               if abs(step["dp"][n] - v) > METRIC_RTOL * abs(v)]
    if step["worst_grad_diff_of_scale"]["value"] > GRAD_OF_SCALE:
        failed.append(f"step gradient {step['worst_grad_diff_of_scale']}")
    loop = result["loop"]
    if len(loop["dp_losses"]) != LOOP_STEPS or abs(
            loop["dp_losses"][0] - loop["single_losses"][0]) > METRIC_RTOL * abs(
            loop["single_losses"][0]):
        failed.append(f"loop losses {loop['dp_losses']} vs {loop['single_losses']}")
    if failed:
        raise SystemExit(f"the sharded runs differ from one card's: {failed}")
    return result


if __name__ == "__main__":
    main()
