"""Seeded weights of a DeepSeek-V2 decoder, leaf by leaf, made on the device.

Each leaf (by its Hugging Face name, in :func:`param_spec`'s fixed order)
comes from a generator of its own, seeded by the run's seed and the leaf's
place in that order, so either side of a run makes any leaf again without
the others, and no single draw holds 15.5 B f32 values. A leaf is drawn in
f32, scaled to its kind's distribution and rounded to the configuration's
compute dtype: the values as served. The program copies them into its
parameters; the plain reference takes them back in f32, one layer at a
time. Distributions: matrices (projections, experts, the router)
N(0, 1/fan_in), the embedding N(0, 1/hidden), RMSNorm scales
1 + N(0, 0.02^2). The output head is not made: retrieval never reads it.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from h100_bench.weights import WEIGHTS, generator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every leaf, in a fixed order."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rdim, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h), "embedding", h)]

    def mat(name, d_out, d_in):
        out.append((name, (d_out, d_in), "linear", d_in))

    def swiglu(p, inter):
        mat(p + "gate_proj.weight", inter, h)
        mat(p + "up_proj.weight", inter, h)
        mat(p + "down_proj.weight", h, inter)

    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.append((p + "input_layernorm.weight", (h,), "norm", h))
        mat(p + "self_attn.q_proj.weight", heads * (nope + rdim), h)
        mat(p + "self_attn.kv_a_proj_with_mqa.weight", rank + rdim, h)
        out.append((p + "self_attn.kv_a_layernorm.weight", (rank,), "norm", rank))
        mat(p + "self_attn.kv_b_proj.weight", heads * (nope + dv), rank)
        mat(p + "self_attn.o_proj.weight", h, heads * dv)
        out.append((p + "post_attention_layernorm.weight", (h,), "norm", h))
        if i < cfg["first_k_dense_replace"]:
            swiglu(p + "mlp.", cfg["intermediate_size"])
        else:
            mat(p + "mlp.gate.weight", cfg["n_routed_experts"], h)
            for e in range(cfg["n_routed_experts"]):
                swiglu(f"{p}mlp.experts.{e}.", cfg["moe_intermediate_size"])
            swiglu(p + "mlp.shared_experts.",
                   cfg["n_shared_experts"] * cfg["moe_intermediate_size"])
    out.append(("model.norm.weight", (h,), "norm", h))
    return out


@torch.no_grad()
def make_leaf(cfg: dict, seed: int, index: int, entry, device) -> torch.Tensor:
    """Leaf ``index`` of :func:`param_spec` (``entry``) in the compute
    dtype, from its own generator."""
    _name, shape, kind, fan_in = entry
    w = torch.randn(shape, generator=generator(device, seed, WEIGHTS, index), device=device)
    if kind == "linear":
        w.mul_(fan_in ** -0.5)
    elif kind == "embedding":
        w.mul_(cfg["hidden_size"] ** -0.5)
    else:  # norm
        w.mul_(0.02).add_(1.0)
    return w.to(DTYPES[cfg["compute_dtype"]])


def leaves(cfg: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, leaf) of every leaf in order, one at a time."""
    for i, entry in enumerate(param_spec(cfg)):
        yield entry[0], make_leaf(cfg, seed, i, entry, device)


class LeafMaker:
    """``leaf(name)``: one leaf by its name, made again from the seed, in
    f32 (the values as served): what the plain reference reads."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.spec = {e[0]: (i, e) for i, e in enumerate(param_spec(cfg))}

    def __call__(self, name: str) -> torch.Tensor:
        i, entry = self.spec[name]
        return make_leaf(self.cfg, self.seed, i, entry, self.device).float()


def total_params(cfg: dict) -> int:
    n = 0
    for _name, shape, _kind, _fan in param_spec(cfg):
        k = 1
        for d in shape:
            k *= d
        n += k
    return n
