"""The corpus-embedding cells of a decoder retriever (DeepSeek-V2 as a
RepLLaMA-style encoder): ``retrieval/embed_corpus.py::generate_embeddings``
over a token cache, pass after pass, as the embed cells run it, with the
model the configuration names built through the port's registry
(``port_model_type``) and ``load_decoder``.

Set-up writes the passages into a token cache under ``TMPDIR``, builds the
model on the card through the port's ``load_decoder`` (its parameters made
empty in the compute dtype, then the seeded leaves streamed in by their
Hugging Face names, one leaf at a time) and runs one pass over a passage
of every length rung, which builds every shape and Triton kernel the
window uses. The window runs whole passes. The traced segment runs
``trace_passes`` more under the profiler with the program's spans, and
reads the expert layers' routed-row counters (``moe_stats``) over it.

The check reads back a seeded sample of the last pass's rows (the longest
passage among them) and compares them with the plain reference
(``reference/deepseek_v2.py``) in f32 on the weights as served
(``emb_gap``, ``bad_rows``). The embeddings cannot see one part of the
model run one precision low: bf16 rounding of the hidden states already
sends about 15% of token-layers to another top-k set than the f32
reference's, and a router or the routed experts in fp8 read inside the
program's ``emb_gap``. So before the program is freed it runs once more
on the sampled passages inside ``recording_blocks``, which keeps every
layer's attention and MLP blocks' input and output rows and the experts
each expert layer routed, and each part is held to an exact computation
on the program's own inputs: ``route_differs``, the share of token-layers
routed to another top-k set than ``softmax(x W_g^T)`` in f64 on the
layer's input with the seeded router leaf, and ``block_gap``, the widest
relative distance of a block's output from the reference's block in f32
on the same input rows with the experts the program routed. For the
calibration the check also reads, on the same rows, what routers with
bf16 or fp8 products would give, each block kind's gap, and the
share of sets that differ from the reference's; ``control`` and
``faults`` read the reference one precision down, whole or in parts.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench import spantrace, traffic, weights_llm, work, work_llm
from h100_bench.drivers.embed import State, buckets, one_pass, read_block, run_pass, sample, \
    write_cache
from h100_bench.reference import deepseek_v2 as reference
from h100_bench.reference.encoder import fp8

from convdr_torch.core.config import DecoderArchConfig
from convdr_torch.core.loading import load_decoder
from convdr_torch.core.registry import get_model_config
from convdr_torch.models import deepseek_v2 as port


@dataclasses.dataclass
class LLMState(State):
    model: Optional[torch.nn.Module] = None
    diagnostics: Optional[dict] = None


def model_cfg(ctx) -> dict:
    """The configuration as the mix serves it: its compute dtype."""
    return dict(ctx.cfg, compute_dtype=ctx.mix["compute_dtype"])


def arch(cfg: dict) -> DecoderArchConfig:
    """The port's decoder architecture at the configuration's widths."""
    rs = cfg["rope_scaling"]
    return DecoderArchConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        q_lora_rank=cfg["q_lora_rank"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]), rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rs["factor"]),
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
    )


def build(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The port's model on ``device`` holding the seeded leaves."""
    mc = get_model_config(cfg["port_model_type"], arch=arch(cfg),
                          embedding_dim=cfg["embedding_dim"])
    _mc, _tok, model = load_decoder(mc, None, device=device,
                                    dtype=weights_llm.DTYPES[cfg["compute_dtype"]],
                                    leaves=weights_llm.leaves(cfg, seed, device))
    return model


def setup(ctx) -> LLMState:
    from convdr_torch.core.loading import make_apply_fn
    from convdr_torch.data.token_cache import TokenCache

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    root = tempfile.mkdtemp(prefix="h100_bench_embed_llm_")
    rows = traffic.passages(mix, cfg["layout"], ctx.seed)
    write_cache(os.path.join(root, "passages"), rows, mix["max_seq_length"])
    warm = [np.resize(rows[0], min(r, mix["max_seq_length"])) for r in buckets(mix)]
    write_cache(os.path.join(root, "warm"), warm, mix["max_seq_length"])
    model = build(model_cfg(ctx), ctx.seed, dev)
    st = LLMState(root, TokenCache(os.path.join(root, "passages")), make_apply_fn(model),
                  np.array([len(r) for r in rows]), model=model)
    run_pass(ctx, st, TokenCache(os.path.join(root, "warm")), os.path.join(root, "warm_out"))
    shutil.rmtree(os.path.join(root, "warm_out"))
    return st


def window(ctx, st: LLMState) -> dict:
    t0 = time.perf_counter()
    passes = 0
    while True:
        one_pass(ctx, st)
        passes += 1
        b = time.perf_counter()
        if b - t0 >= ctx.seconds:
            break
    least = work_llm.encoder_flops(ctx.cfg, st.lengths) / work.peaks()["bf16_flops_per_s"]
    n = len(st.lengths) * passes
    return {"window_s": b - t0, "least_s": [least] * passes, "attempted": n, "units": n}


def traced(ctx, st: LLMState) -> dict:
    n = ctx.mix["trace_passes"]
    port.reset_moe_stats(st.model)

    def segment():
        for _ in range(n):
            one_pass(ctx, st)

    tr = spantrace.traced(segment, ctx.device)
    stats = port.moe_stats(st.model)
    cfg = ctx.cfg
    layers, moe_layers = cfg["num_hidden_layers"], \
        cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    tokens = int(st.lengths.sum())
    w = {"mla": work_llm.attention_fwd(cfg, st.lengths) * (layers * n),
         "experts": work_llm.grouped_experts(cfg, tokens) * (moe_layers * n)}
    return {"trace": tr, "work": w, "moe": stats}


def recorded_blocks(model, ids: torch.Tensor, mask: torch.Tensor) -> list:
    """One forward of the program over ``ids``; each layer's record of it
    (``recording_blocks``): ``{"blocks": [(kind, input, output)],
    "experts": [(chosen, routed sum)] or None}``."""
    with port.recording_blocks(model) as layers, torch.inference_mode():
        model.body_emb(ids, mask)
    return layers


def program_records(cfg: dict, layers: list, n_tokens: int) -> Optional[list]:
    """The program's blocks as ``(layer, kind, input rows, output rows,
    routed experts or None)``: each layer's "attn" and "mlp", and each
    expert layer's "routed" (its routed experts' weighted sum, on the MLP
    block's input); None unless every layer recorded its blocks once over
    all ``n_tokens`` rows and every expert layer its choices."""
    first = cfg["first_k_dense_replace"]
    if len(layers) != cfg["num_hidden_layers"]:
        return None
    out = []
    for i, layer in enumerate(layers):
        blocks, experts = layer["blocks"], layer["experts"]
        if [b[0] for b in blocks] != ["attn", "mlp"] or \
                any(b[1].shape[0] != n_tokens or b[2].shape[0] != n_tokens for b in blocks) or \
                (experts is None) != (i < first) or (experts is not None and (
                    len(experts) != 1 or experts[0][0].shape[0] != n_tokens
                    or experts[0][1].shape[0] != n_tokens)):
            return None
        if experts is None:
            out += [(i, kind, x, y, None) for kind, x, y in blocks]
            continue
        (_, x, _), (chosen, routed) = blocks[1], experts[0]
        out += [(i, kind, x, y, chosen if kind == "mlp" else None) for kind, x, y in blocks]
        out.append((i, "routed", x, routed, chosen))
    return out


# routers below the configuration's f32 logits, as logits from a layer's
# input rows x and router weight w: the faults the check has to catch (a
# TF32 product is none here: the rows and the weights are bf16 values,
# which TF32 holds exactly)
ROUTER_FAULTS = {
    "bf16": lambda x, w: F.linear(x.bfloat16(), w.bfloat16()).float(),
    "fp8": lambda x, w: fp8(x.float()) @ fp8(w.float()).T,
}


def route_differs(cfg: dict, leaf, records: Optional[list], logits=None) -> float:
    """The share of token-layers whose routed top-k set differs from the
    exact router's: top-k of ``softmax(x W_g^T)`` in f64 on the layer's
    own input rows x, W_g the seeded router leaf. ``logits(x, w)`` stands
    in for the recorded choices (a fault's router). NaN without records."""
    if not records:
        return float("nan")
    k = cfg["num_experts_per_tok"]
    differ = rows = 0
    for i, kind, x, _y, chosen in records:
        if kind != "routed":
            continue
        w = leaf(f"model.layers.{i}.mlp.gate.weight")
        exact = torch.topk(torch.softmax(x.double() @ w.double().T, dim=-1), k, dim=-1)[1]
        if logits is not None:
            chosen = torch.topk(logits(x, w), k, dim=-1)[1]
        same = torch.sort(exact, 1)[0] == torch.sort(chosen.to(exact.device), 1)[0]
        differ += int((~same.all(1)).sum())
        rows += x.shape[0]
    return differ / rows if rows else float("nan")


def block_gaps(cfg: dict, leaf, records: Optional[list], lengths, stand_ins=None) -> dict:
    """Each block's relative distance (Frobenius, over its rows) from the
    plain reference's block in f32 on the same input rows, with the routed
    experts the record names; the widest a kind: ``{"attn": .., "mlp": ..,
    "routed": ..}`` for the outputs in ``records`` (``(layer, kind, input, output,
    experts or None)``). With ``stand_ins`` (``{name: kind -> roundings of
    reference.block}``, a fault's or the control's) the reference under
    each stands in for the outputs: ``{name: widest over blocks}``. A
    block of the program keeps its own roundings, so a product run one
    precision low shows in its block whatever the layers before it did."""
    if not records:
        return {"attn": float("nan"), "mlp": float("nan"), "routed": float("nan")}
    trig = reference.rope_tables(cfg, lengths, records[0][2].device)
    gaps = {name: 0.0 for name in (stand_ins or ("attn", "mlp", "routed"))}
    w, at = None, None
    with torch.no_grad():
        for i, kind, x, y, top_e in records:
            if i != at:
                w, at = reference.layer_leaves(leaf), i
            h = x.float()
            want, _ = reference.block(cfg, w, i, kind, h, lengths, trig, top_e=top_e)
            norm = torch.linalg.vector_norm(want)
            if stand_ins is None:
                gap = torch.linalg.vector_norm(y.float() - want) / norm
                gaps[kind] = max(gaps[kind], float(gap))
                continue
            for name, roundings in stand_ins.items():
                kw = roundings(kind)
                if kw:
                    got, _ = reference.block(cfg, w, i, kind, h, lengths, trig, top_e=top_e, **kw)
                    gaps[name] = max(gaps[name], float(torch.linalg.vector_norm(got - want) / norm))
    return gaps


def _sample_rows(ctx, offsets):
    rows = traffic.passages(ctx.mix, ctx.cfg["layout"], ctx.seed)
    return [rows[int(o)] for o in offsets]


def check(ctx, st: LLMState, obs: dict) -> dict:
    emb, ids = read_block(st.last_dir)
    n = len(st.lengths)
    counts = np.bincount(ids[(ids >= 0) & (ids < n)], minlength=n)
    bad = int(np.sum(counts != 1)) + int(np.sum((ids < 0) | (ids >= n)))
    if emb.shape[0] != ids.shape[0]:
        bad += abs(emb.shape[0] - ids.shape[0])
    offsets = sample(ctx, st.lengths)
    row_of = {int(o): r for r, o in enumerate(ids)}
    found = [o for o in offsets if int(o) in row_of]
    prog = torch.from_numpy(emb[[row_of[int(o)] for o in found]]).to(ctx.device)
    seqs = _sample_rows(ctx, found)
    width = max(len(s) for s in seqs) if seqs else 1
    pad_ids = np.zeros((len(seqs), width), np.int32)
    pad_mask = np.zeros_like(pad_ids)
    for i, s in enumerate(seqs):
        pad_ids[i, :len(s)] = s
        pad_mask[i, :len(s)] = 1
    cfg = model_cfg(ctx)
    leaf = weights_llm.LeafMaker(cfg, ctx.seed, ctx.device)
    lengths = [len(s) for s in seqs]
    layers = recorded_blocks(st.model, torch.from_numpy(pad_ids).to(ctx.device),
                             torch.from_numpy(pad_mask).to(ctx.device)) if seqs else []
    records = program_records(cfg, layers, sum(lengths))
    del layers
    routing = route_differs(cfg, leaf, records)
    diag = {f"route_differs_{name}_router": route_differs(cfg, leaf, records, fn)
            for name, fn in ROUTER_FAULTS.items()}
    chosen = [r[4].cpu() for r in records or [] if r[1] == "routed"]
    shutil.rmtree(st.root)
    st.cache = st.apply_fn = st.model = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    gaps, ref_choices = reference_gaps(ctx, seqs, prog)
    blocks = block_gaps(cfg, leaf, records, lengths)
    del records
    diag.update({f"block_gap_{kind}": g for kind, g in blocks.items()})
    if chosen and len(chosen) == len(ref_choices):
        differ = [(torch.sort(p, 1)[0] != torch.sort(r.cpu(), 1)[0]).any(1)
                  for p, r in zip(chosen, ref_choices)]
        diag["reference_sets_differ"] = float(torch.cat(differ).float().mean())
    st.diagnostics = diag
    return dict(gaps, block_gap=max(blocks.values()), route_differs=routing,
                bad_rows=float(bad))


def reference_gaps(ctx, seqs, prog: torch.Tensor):
    """(``emb_gap``: the widest relative distance of the rows ``prog`` from
    the plain reference's embeddings of the token sequences ``seqs``; the
    reference's expert choices)."""
    cfg = model_cfg(ctx)
    leaf = weights_llm.LeafMaker(cfg, ctx.seed, ctx.device)
    t = [torch.from_numpy(np.asarray(s)).to(ctx.device) for s in seqs]
    ref, choices = reference.embed_sequences(cfg, leaf, t)
    return {"emb_gap": _emb_gap(prog.float(), ref) if len(seqs) else float("nan")}, choices


def _reference_records(ctx):
    """(cfg, leaf, the sampled sequences on the device, the reference's
    embeddings of them, its blocks as ``(layer, kind, input, None,
    experts)``, each expert layer's routed experts as "routed") for a
    control or a fault."""
    lengths = np.array([len(r) for r in traffic.passages(ctx.mix, ctx.cfg["layout"], ctx.seed)])
    seqs = _sample_rows(ctx, sample(ctx, lengths))
    cfg = model_cfg(ctx)
    leaf = weights_llm.LeafMaker(cfg, ctx.seed, ctx.device)
    t = [torch.from_numpy(np.asarray(s)).to(ctx.device) for s in seqs]
    record = []
    ref, _ = reference.embed_sequences(cfg, leaf, t, record=record)
    blocks = []
    for i, kind, h, top_e in record:
        blocks.append((i, kind, h, None, top_e))
        if top_e is not None:
            blocks.append((i, "routed", h, None, top_e))
    return cfg, leaf, t, ref, blocks


def _emb_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((torch.linalg.vector_norm(a - ref, dim=1)
                  / torch.linalg.vector_norm(ref, dim=1)).max())


def control(ctx) -> dict:
    """The control's numbers: the plain reference with fp8 (e4m3) operands
    in every product, the router's included (the precision below the
    configuration's bf16), on the passages a check samples: its
    embeddings, its blocks on the reference's block inputs, its router on
    the reference's router inputs."""
    cfg, leaf, t, ref, records = _reference_records(ctx)
    low, _ = reference.embed_sequences(cfg, leaf, t, rnd=fp8)
    lengths = [int(s.numel()) for s in t]
    blocks = block_gaps(cfg, leaf, records, lengths, {"fp8": lambda kind: {"rnd": fp8}})
    return {"emb_gap": _emb_gap(low, ref), "block_gap": blocks["fp8"],
            "route_differs": route_differs(cfg, leaf, records, ROUTER_FAULTS["fp8"]),
            "bad_rows": 0.0}


def faults(ctx) -> dict:
    """The faults' numbers, each a part of the model one precision down
    (fp8 e4m3 operands) with every other product in f32: ``block_gap``
    with the attention blocks, the routed experts, or the MLP blocks
    (dense, shared, routed, the router's weights) in fp8; ``route_differs``
    of a bf16 router; and ``emb_gap`` with the routers, or the routed
    experts, in fp8."""
    cfg, leaf, t, ref, records = _reference_records(ctx)
    lengths = [int(s.numel()) for s in t]
    blocks = block_gaps(cfg, leaf, records, lengths, {
        "attn_fp8": lambda kind: {"rnd": fp8} if kind == "attn" else {},
        "experts_fp8": lambda kind: {"rnd_experts": fp8} if kind == "routed" else {},
        "mlp_fp8": lambda kind: {"rnd": fp8} if kind == "mlp" else {}})
    out = {f"{name}_block_gap": g for name, g in blocks.items()}
    out["router_bf16_route_differs"] = route_differs(cfg, leaf, records, ROUTER_FAULTS["bf16"])
    del records
    for name, kw in (("router_fp8", {"rnd_router": fp8}), ("experts_fp8", {"rnd_experts": fp8})):
        low, _ = reference.embed_sequences(cfg, leaf, t, **kw)
        out[f"{name}_emb_gap"] = _emb_gap(low, ref)
    return out
