"""The yardstick of the decoder cells: the active operations of a
DeepSeek-V2 encoder's forward, the grouped expert product's operations and
bytes, and the causal latent attention's, counted from the shapes as
``work.py`` counts the encoder cells' (each input read once, each output
written once, only what the valid tokens need)."""

from __future__ import annotations

from typing import Iterable

from h100_bench.work import Work


def _dims(cfg: dict):
    heads = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return cfg["hidden_size"], heads, qk, cfg["v_head_dim"]


def token_flops(cfg: dict) -> float:
    """Matmul operations of one token through every layer, attention's
    scores aside: the latent attention's four projections, the dense
    layers' SwiGLU, and in each expert layer the router, the k routed
    experts' SwiGLUs and the shared experts'. The embedding lookup and the
    norms are left out (bandwidth, not operations); so is the output head,
    which retrieval never runs."""
    h, heads, qk, dv = _dims(cfg)
    attn = 2 * h * heads * qk + 2 * h * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]) \
        + 2 * cfg["kv_lora_rank"] * heads * (cfg["qk_nope_head_dim"] + dv) + 2 * heads * dv * h
    dense = 6 * h * cfg["intermediate_size"]
    moe_i = cfg["moe_intermediate_size"]
    expert = 2 * h * cfg["n_routed_experts"] + 6 * h * moe_i * cfg["num_experts_per_tok"] \
        + 6 * h * moe_i * cfg["n_shared_experts"]
    n_dense = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    return float(layers * attn + n_dense * dense + (layers - n_dense) * expert)


def pair_flops(cfg: dict) -> float:
    """Operations of one causal query-key pair in one layer: q k and p v."""
    _h, heads, qk, dv = _dims(cfg)
    return 2.0 * heads * (qk + dv)


def encoder_flops(cfg: dict, valid: Iterable[int]) -> float:
    """Active operations of one forward over sequences of ``valid`` tokens
    each: :func:`token_flops` a token, :func:`pair_flops` a causal pair in
    every layer."""
    per_tok, per_pair = token_flops(cfg), pair_flops(cfg) * cfg["num_hidden_layers"]
    return float(sum(n * per_tok + n * (n + 1) / 2 * per_pair for n in valid))


def attention_fwd(cfg: dict, valid: Iterable[int], elem: int = 2) -> Work:
    """One layer's causal latent attention over sequences of ``valid``
    tokens: :func:`pair_flops` a valid causal pair; q and k (the query/key
    head dim), v and the output (the value head dim) each read or written
    once over the valid tokens."""
    _h, heads, qk, dv = _dims(cfg)
    w = Work()
    for n in valid:
        w = w + Work(pair_flops(cfg) * n * (n + 1) / 2, elem * n * heads * (2 * qk + 2 * dv))
    return w


def grouped_experts(cfg: dict, tokens: int, elem: int = 2) -> Work:
    """One expert layer's grouped SwiGLU over ``tokens`` valid tokens: k
    routed rows a token, each ``6 hidden moe_intermediate`` operations;
    the tokens' rows read once, every routed expert's three matrices read
    once, each routed row's output written once."""
    h, i, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    rows = tokens * k
    return Work(6.0 * h * i * rows,
                elem * (tokens * h + 3 * cfg["n_routed_experts"] * h * i + rows * h))
