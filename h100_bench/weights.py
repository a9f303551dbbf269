"""Seeded inputs made on the device: model weights and corpus rows.

Both sides of a run (the program and the plain reference) take these,
made again from the seed wherever a side needs them, so neither reads
anything the other has made. Parameter names and shapes follow the public
Hugging Face layout of the configuration's family (``roberta.*`` with the
ANCE head's ``embeddingHead`` / ``norm``, or DPR's ``question_model.*`` and
``ctx_model.*``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# purposes of a run's device draws
WEIGHTS, CORPUS = 11, 12


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for one purpose of one run."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(torch_seed(seed, *tags))


def tower_spec(cfg: dict, prefix: str) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of one BERT/RoBERTa encoder's leaves."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    out = [
        (f"{prefix}embeddings.word_embeddings.weight", (v, h), "embedding", h),
        (f"{prefix}embeddings.position_embeddings.weight",
         (cfg["max_position_embeddings"], h), "embedding", h),
    ]
    if cfg["type_vocab_size"] > 0:
        out.append((f"{prefix}embeddings.token_type_embeddings.weight",
                    (cfg["type_vocab_size"], h), "embedding", h))
    out += [(f"{prefix}embeddings.LayerNorm.weight", (h,), "ln_scale", h),
            (f"{prefix}embeddings.LayerNorm.bias", (h,), "ln_shift", h)]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{prefix}encoder.layer.{layer}."
        for sub, (d_in, d_out) in (("attention.self.query", (h, h)),
                                   ("attention.self.key", (h, h)),
                                   ("attention.self.value", (h, h)),
                                   ("attention.output.dense", (h, h)),
                                   ("intermediate.dense", (h, i)),
                                   ("output.dense", (i, h))):
            out += [(f"{p}{sub}.weight", (d_out, d_in), "linear", d_in),
                    (f"{p}{sub}.bias", (d_out,), "bias", d_in)]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(f"{p}{ln}.weight", (h,), "ln_scale", h),
                    (f"{p}{ln}.bias", (h,), "ln_shift", h)]
    return out


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str, int]]:
    """Every leaf of the configuration's model, in a fixed order."""
    if cfg["towers"] == 2:
        return tower_spec(cfg, "question_model.") + tower_spec(cfg, "ctx_model.")
    spec = tower_spec(cfg, "roberta.")
    if cfg["head"] == "linear_layernorm":
        h, e = cfg["hidden_size"], cfg["embedding_dim"]
        spec += [("embeddingHead.weight", (e, h), "linear", h),
                 ("embeddingHead.bias", (e,), "bias", h),
                 ("norm.weight", (e,), "ln_scale", e),
                 ("norm.bias", (e,), "ln_shift", e)]
    return spec


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's f32 weights: one normal draw on the device for every
    leaf, each leaf's slice then scaled to its kind's distribution."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(shape)) for _, shape, _, _ in spec)
    flat = torch.randn(total, generator=generator(device, seed, WEIGHTS), device=device)
    out, lo = {}, 0
    for name, shape, kind, fan_in in spec:
        n = int(np.prod(shape))
        w = flat[lo:lo + n].view(shape)
        lo += n
        if kind == "linear":
            w.mul_(fan_in ** -0.5)
        elif kind == "embedding":
            w.mul_(cfg["hidden_size"] ** -0.5)
        elif kind == "ln_scale":
            w.mul_(0.02).add_(1.0)
        else:  # bias, ln_shift
            w.mul_(0.02)
        out[name] = w
    return out


def as_served(cfg: dict, w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``w`` with every linear and embedding leaf rounded to ``dtype`` and
    back to f32 (LayerNorms stay f32): the values a model served in
    ``dtype`` holds, for a reference that computes on them in f32."""
    cast = {name for name, _shape, kind, _fan in param_spec(cfg)
            if kind in ("linear", "bias", "embedding")}
    return {n: t.to(dtype).float() if n in cast else t for n, t in w.items()}


def corpus_blocks(cfg: dict) -> List[Tuple[int, int]]:
    """(first row, rows) of each generator's block of the corpus."""
    n, step = cfg["corpus_rows"], cfg["block_rows"]
    return [(lo, min(step, n - lo)) for lo in range(0, n, step)]


@torch.no_grad()
def corpus_block(cfg: dict, seed: int, b: int, device, out: torch.Tensor = None) -> torch.Tensor:
    """Block ``b`` of the corpus, N(0, 1) f32 rows from its own generator,
    so either side can make any block again on its own."""
    _lo, rows = corpus_blocks(cfg)[b]
    shape = (rows, cfg["embedding_dim"])
    g = generator(device, seed, CORPUS, b)
    if out is None:
        return torch.randn(shape, generator=g, device=device)
    return torch.randn(shape, generator=g, device=device, out=out)


@torch.no_grad()
def make_corpus(cfg: dict, seed: int, device, row_tile: int) -> torch.Tensor:
    """The whole corpus, its rows padded with zeros to ``row_tile``."""
    n, d = cfg["corpus_rows"], cfg["embedding_dim"]
    if cfg["corpus_dtype"] != "float32":
        raise ValueError(f"corpus dtype {cfg['corpus_dtype']!r} is not made here")
    corpus = torch.empty((-(-n // row_tile) * row_tile, d), device=device)
    corpus[n:].zero_()
    for b, (lo, rows) in enumerate(corpus_blocks(cfg)):
        corpus_block(cfg, seed, b, device, out=corpus[lo:lo + rows])
    return corpus
