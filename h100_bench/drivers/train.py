"""The training cells: the port's KD + ranking train step
(``make_train_step`` and its clipped AdamW), fed batch after batch as
``train/loop.py`` feeds it: each batch's arrays uploaded, one step, its
loss read back.

Set-up builds one train state from the seed and drives it through its
first ``checked_steps`` steps, on different batches, through the same call
and feed as the window: each step's loss, the first step's clipped
gradient (from the optimizer's first moment) and the parameters' change
over those steps are read as norms for the comparison. The window goes on
with that same state. The traced segment runs ``trace_steps`` more steps
under the profiler, then times the teacher's document forward alone
between CUDA events. The check frees the program and runs the plain step
over the same first batches.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from h100_bench import checks, devtrace, program, traffic, weights, work
from h100_bench.reference.train import PlainTrainer

B1 = 0.9


@dataclass
class State:
    train_state: object
    step_fn: object
    teacher: object
    batches: List[Dict[str, np.ndarray]]
    next_step: int = 0
    readings: dict = field(default_factory=dict)
    diagnostics: dict = field(default_factory=dict)


def upload(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(v).to(dev) for n, v in batch.items()}


def step(ctx, st: State) -> float:
    """The next step of the loop; returns its loss."""
    batch = upload(st.batches[st.next_step % len(st.batches)], ctx.device)
    st.next_step += 1
    st.train_state, metrics = st.step_fn(st.train_state, batch)
    return float(metrics["loss"])


def setup(ctx) -> State:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    batches = traffic.train_batches(mix, cfg["layout"], ctx.seed)
    w0 = weights.make_weights(cfg, ctx.seed, dev)
    train_state, step_fn, teacher = program.train_step(cfg, mix, w0, dev)
    st = State(train_state, step_fn, teacher, batches)
    losses = []
    for s in range(mix["checked_steps"]):
        losses.append(step(ctx, st))
        if s == 0:
            mu = st.train_state.opt_state["mu"]
            grad = {n: v / (1 - B1) for n, v in checks.norms(mu).items()}
    params = dict(st.train_state.model.named_parameters())
    with torch.no_grad():
        change = checks.norms({n: params[n] - w0[n] for n in w0})
    st.readings = {"losses": losses, "grad": grad, "change": change}
    return st


def least_s(cfg: dict, pk: dict, batch: Dict[str, np.ndarray]) -> float:
    """The least time of one step: the student's forward and backward
    (three forwards' operations) on its conversations, the teacher's
    forwards on the rewrites and the documents, at the bf16 peak."""
    flops = (3 * work.encoder_flops(cfg, batch["concat_mask"].sum(1))
             + work.encoder_flops(cfg, batch["target_mask"].sum(1))
             + work.encoder_flops(cfg, batch["doc_mask"].reshape(-1, batch["doc_mask"].shape[-1])
                                  .sum(1)))
    return flops / pk["bf16_flops_per_s"]


def window(ctx, st: State) -> dict:
    first = st.next_step
    t0 = time.perf_counter()
    while True:
        step(ctx, st)
        b = time.perf_counter()
        if b - t0 >= ctx.seconds:
            break
    steps = range(first, st.next_step)
    b_size = ctx.mix["batch_size"]
    pk = work.peaks()
    least = [least_s(ctx.cfg, pk, st.batches[i % len(st.batches)]) for i in steps]
    return {"window_s": b - t0, "least_s": least, "attempted": len(steps) * b_size,
            "units": len(steps) * b_size}


def traced(ctx, st: State) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    first, n = st.next_step, mix["trace_steps"]

    def segment():
        for _ in range(n):
            step(ctx, st)

    tr = devtrace.traced(segment, dev)
    fwd, bwd = work.Work(), work.Work()
    for i in range(first, first + n):
        b = st.batches[i % len(st.batches)]
        concat = b["concat_mask"].sum(1)
        docs = b["doc_mask"].reshape(-1, b["doc_mask"].shape[-1]).sum(1)
        fwd = (fwd + work.attention_fwd(cfg, concat, 4, with_lse=True)
               + work.attention_fwd(cfg, b["target_mask"].sum(1), 4)
               + work.attention_fwd(cfg, docs, 4))
        bwd = bwd + work.attention_bwd(cfg, concat, 4)
    layers = cfg["num_hidden_layers"]
    spans = {}
    if dev.type == "cuda":
        from convdr_torch.core.loading import make_apply_fn

        apply_fn = make_apply_fn(st.teacher)
        total = 0.0
        for rep in range(mix["span_reps"]):
            b = upload(st.batches[(first + rep) % len(st.batches)], dev)
            k, length = b["doc_ids"].shape[1:]
            ids, mask = b["doc_ids"].reshape(-1, length), b["doc_mask"].reshape(-1, length)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            apply_fn(ids, mask, False)
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        spans["teacher_docs"] = total / mix["span_reps"]
    return {"trace": tr, "work": {"attn_fwd": fwd * layers, "attn_bwd": bwd * layers},
            "spans_ms": spans}


def check(ctx, st: State, obs: dict) -> dict:
    """Free the program; run the plain step over the first batches and
    compare the readings set-up took."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    readings = st.readings
    st.train_state = st.step_fn = st.teacher = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_run(cfg, mix, ctx.seed, dev, st.batches)
    st.diagnostics = {
        "losses": [readings["losses"], ref["losses"]],
        "grad": checks.worst_leaves(readings["grad"], ref["grad"]),
        "change": checks.worst_leaves(readings["change"], ref["change"],
                                      checks.moving_leaves(ref["grad"])),
    }
    return checks.train_numbers(readings["losses"], ref["losses"], readings["grad"],
                                ref["grad"], readings["change"], ref["change"])


def reference_run(cfg, mix, seed, dev, batches, *, rows: slice = slice(None)) -> dict:
    """The plain trainer's readings over the first ``checked_steps``
    batches (``rows`` of each: a planted fault leaves some out)."""
    w0 = weights.make_weights(cfg, seed, dev)
    ref = PlainTrainer(cfg, mix, w0)
    for s in range(mix["checked_steps"]):
        ref.step(upload(batches[s], dev), rows=rows)
    with torch.no_grad():
        change = checks.norms({n: ref.student[n] - w0[n] for n in w0})
    return {"losses": ref.losses, "grad": {n: float(v) for n, v in ref.grad_norms[0].items()},
            "change": change}


def control(ctx) -> dict:
    """The control's numbers: the plain trainer in TF32 (the precision
    below the configuration's f32 with TF32 off) against the f32 one."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    batches = traffic.train_batches(mix, cfg["layout"], ctx.seed)
    with checks.tf32():
        ctl = reference_run(cfg, mix, ctx.seed, dev, batches)
    return _judge(ctl, reference_run(cfg, mix, ctx.seed, dev, batches))


def faults(ctx) -> dict:
    """Each planted fault's numbers: half of the batch left out (the mean
    taken over the rest), in the plain trainer put in the program's place.
    A step that leaves its state unchanged reads ``update_gap`` 1 by
    definition, with no run."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    batches = traffic.train_batches(mix, cfg["layout"], ctx.seed)
    ref = reference_run(cfg, mix, ctx.seed, dev, batches)
    half = reference_run(cfg, mix, ctx.seed, dev, batches, rows=slice(0, mix["batch_size"] // 2))
    return {"half_batch": _judge(half, ref)}


def _judge(prog: dict, ref: dict) -> dict:
    return checks.train_numbers(prog["losses"], ref["losses"], prog["grad"], ref["grad"],
                                prog["change"], ref["change"])
