"""Model/tokenizer loading: the ``load_model`` equivalent.

The counterpart of ``convdr_tpu/core/loading.py`` for these checkpoint
flavors:

  * **reference torch format** -- HF ``save_pretrained`` dirs
    (pytorch_model.bin/model.safetensors) of the ANCE models, and DPR
    ``CheckpointState`` files or HF-style dirs of the dpr models (the port's
    own training output among them), via
    :mod:`convdr_torch.models.import_torch`;
  * **fresh init** -- checkpoint path ``None``/"init", seeded with an
    explicit ``torch.Generator``.

  * **the JAX package's orbax dirs** -- ``final/`` of a train run (or the
    dir itself), read without orbax by
    :func:`convdr_torch.train.checkpoint.read_orbax_tree` and mapped by
    :func:`~convdr_torch.models.from_jax.flax_params_to_state_dict`.

Tokenizers load from vocab files
colocated with the checkpoint, an explicit path, or the deterministic
"tiny" test vocab.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from convdr_torch.core.config import EncoderArchConfig, ModelConfig
from convdr_torch.core.registry import get_model_config
from convdr_torch.data.tokenizers import ByteLevelBPETokenizer, WordPieceTokenizer
from convdr_torch.models.encoders import build_model
from convdr_torch.models.import_torch import (
    dpr_state_dict,
    load_state_dict_checked,
    load_torch_state_dict,
)
from convdr_torch.models.transformer import cast_at_use, to_compute_dtype


def load_tokenizer_for(config: ModelConfig, path: Optional[str]) -> Any:
    """Resolve a tokenizer for a checkpoint path.

    None/"tiny"/"init" -> the deterministic test vocab. A directory must
    contain vocab files (itself or, for single-file checkpoints, its parent
    directory). A path that names no vocab raises instead of silently
    degrading to the tiny vocab.
    """
    cls = (
        ByteLevelBPETokenizer
        if config.tokenizer_kind == "roberta"
        else WordPieceTokenizer
    )
    if path in (None, "tiny", "init"):
        return cls.tiny()
    vocab_marker = (
        "vocab.json" if config.tokenizer_kind == "roberta" else "vocab.txt"
    )
    candidates = []
    if os.path.isdir(path):
        candidates.append(path)
    elif os.path.isfile(path):
        candidates.append(os.path.dirname(path) or ".")
    for cand in candidates:
        if os.path.exists(os.path.join(cand, vocab_marker)):
            return cls.from_pretrained(cand)
    raise FileNotFoundError(
        f"No {vocab_marker} found for tokenizer at {path!r}; pass "
        "tokenizer_path explicitly (or 'tiny' for the test vocab)"
    )


def resolve_orbax_dir(path: str) -> Optional[str]:
    """The orbax tree dir the JAX package's checkpointer wrote at ``path``
    (itself, or its ``final/`` as the train drivers write it), else None:
    orbax's ``_CHECKPOINT_METADATA``, or the JAX package's
    ``convdr_meta.json`` side file without the port's own ``train_state.pt``
    beside it (:mod:`convdr_torch.train.checkpoint` writes both)."""
    if not os.path.isdir(path):
        return None
    for cand in (path, os.path.join(path, "final")):
        def has(name):
            return os.path.exists(os.path.join(cand, name))

        if has("_CHECKPOINT_METADATA") or (has("convdr_meta.json")
                                           and not has("train_state.pt")):
            return cand
    return None


def _is_orbax_dir(path: str) -> bool:
    return resolve_orbax_dir(path) is not None


def _is_torch_checkpoint(path: str) -> bool:
    if os.path.isdir(path):
        return any(
            os.path.exists(os.path.join(path, n))
            for n in ("pytorch_model.bin", "model.safetensors")
        )
    return os.path.isfile(path)


# flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# scales it by sqrt(1 / fan_in) / (the truncated normal's own std)
_TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init from the JAX package's distributions (flax's defaults):
    linear weights truncated normal at two standard deviations with
    variance 1/fan_in (``lecun_normal``), embeddings normal with variance
    1/features, zero biases, unit LayerNorms. (Hugging Face's normal(0,
    0.02) would make the tiny models' untrained embeddings nearly the same
    for every input, where the JAX package's random-init teacher ranks
    passages, as the rehearsal needs.)"""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = (1.0 / m.in_features) ** 0.5 / _TRUNCATED_NORMAL_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=gen)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def resize_token_embeddings(
    state_dict: Dict[str, torch.Tensor], new_size: int, seed: int = 0
) -> Dict[str, torch.Tensor]:
    """Grow word-embedding tables to ``new_size`` rows (normal(0, 0.02)
    rows from ``np.random.RandomState(seed)``, the same draws as the JAX
    package's ``resize_token_embeddings``), the equivalent of HF
    ``resize_token_embeddings`` after ``add_tokens``."""
    rng = np.random.RandomState(seed)
    out = dict(state_dict)
    for key, emb in state_dict.items():
        if key.endswith("word_embeddings.weight") and emb.shape[0] < new_size:
            extra = rng.normal(
                0.0, 0.02, size=(new_size - emb.shape[0], emb.shape[1])
            ).astype(np.float32)
            out[key] = torch.cat([emb, torch.from_numpy(extra).to(emb.dtype)])
    return out


def gelu_arch_overrides(gelu: str, dtype_name: str) -> Optional[dict]:
    """Resolve a driver ``--gelu {auto,erf,tanh}`` flag to arch overrides.

    "auto" picks tanh under bf16 compute (where the erf/tanh difference is
    below the bf16 noise floor) and exact erf under f32 (checkpoint-import
    numerical parity).
    """
    if gelu not in ("auto", "erf", "tanh"):
        raise ValueError(f"unknown gelu flavor {gelu!r}")
    use_tanh = gelu == "tanh" or (gelu == "auto" and dtype_name == "bfloat16")
    return {"gelu_approximate": True} if use_tanh else None


def load_model_and_params(
    model_type: str,
    checkpoint_path: Optional[str],
    *,
    device: torch.device,
    tokenizer_path: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    arch_preset: Optional[str] = None,
    arch_overrides: Optional[dict] = None,
    extra_tokens: Tuple[str, ...] = (),
    seed: int = 0,
    f32_params: bool = False,
) -> Tuple[ModelConfig, Any, nn.Module]:
    """Returns (config, tokenizer, model): the model in eval mode on
    ``device``, linear layers and embeddings computing in ``dtype``.

    By default their parameters are cast to ``dtype`` (inference, the
    frozen teacher). ``f32_params`` keeps every parameter f32 and casts it
    where it is used (:func:`cast_at_use`): a student for training in bf16
    whose optimizer updates f32 masters, as the JAX package's flax modules
    keep f32 params under ``dtype=bf16``.

    arch_preset "tiny" swaps in the miniature architecture (hermetic tests /
    smoke runs); None keeps the registry's base architecture.
    ``extra_tokens`` are added to the tokenizer (``<response>`` for the
    man_can / auto_can query modes) and the word embeddings grow to match.
    """
    config = get_model_config(model_type)
    tokenizer = load_tokenizer_for(config, tokenizer_path or checkpoint_path)
    for tok in extra_tokens:
        tokenizer.add_tokens([tok])

    arch = config.arch
    if arch_preset == "tiny":
        arch = EncoderArchConfig.tiny(
            vocab_size=len(tokenizer) + 8,
            roberta=config.tokenizer_kind == "roberta",
        )
        config = dataclasses.replace(
            config,
            embedding_dim=min(config.embedding_dim, 32),
            chunk_len=min(config.chunk_len, 32),
        )
    updates = dict(arch_overrides or {})
    vocab_needed = len(tokenizer)
    if vocab_needed > updates.get("vocab_size", arch.vocab_size):
        updates["vocab_size"] = vocab_needed
    if updates:
        arch = dataclasses.replace(arch, **updates)
    config = dataclasses.replace(config, arch=arch)

    # Keep the tokenizer's declared capacity in sync with the actual
    # position-embedding table so driver-side clamps
    # (min(max_concat_length, max_len_single_sentence)) are meaningful.
    tokenizer.model_max_length = (
        config.arch.max_position_embeddings - config.arch.position_offset
    )

    model = build_model(config)
    if checkpoint_path in (None, "init"):
        init_weights(model, seed)
    else:
        if _is_orbax_dir(checkpoint_path):
            # deferred: train.checkpoint imports this module through the trainer
            from convdr_torch.train.checkpoint import load_orbax_params, read_orbax_tree

            state_dict = load_orbax_params(model, read_orbax_tree(checkpoint_path),
                                           checkpoint_path)
        elif _is_torch_checkpoint(checkpoint_path):
            state_dict = load_torch_state_dict(checkpoint_path)
            if config.two_tower:
                state_dict = dpr_state_dict(state_dict)
        else:
            raise FileNotFoundError(f"No checkpoint at {checkpoint_path}")
        load_state_dict_checked(
            model, resize_token_embeddings(state_dict, config.arch.vocab_size, seed)
        )
    model = (cast_at_use if f32_params else to_compute_dtype)(model, dtype)
    model = model.to(device).eval()
    return config, tokenizer, model


def make_apply_fn(model: nn.Module, *, grad: bool = False) -> Callable:
    """(ids, mask, is_query) -> f32 embeddings.

    Without autograd by default (inference, the frozen teacher);
    ``grad=True`` keeps autograd on, for the student of a train step.
    """

    def apply_fn(ids, mask, is_query: bool):
        return model.query_emb(ids, mask) if is_query else model.body_emb(ids, mask)

    return apply_fn if grad else torch.inference_mode()(apply_fn)
