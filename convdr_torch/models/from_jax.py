"""The JAX package's parameter tree -> this package's ``state_dict``.

Inverts the layout that ``convdr_tpu/models/import_torch.py::
hf_encoder_to_flax`` builds: ``DenseGeneral`` q/k/v kernels
``[hidden, heads, head_dim]`` and the attention output kernel
``[heads, head_dim, hidden]`` become ``Linear.weight [out, in]``, ``Dense``
kernels ``[in, out]`` are transposed, and LayerNorm ``scale`` becomes
``weight``. The input is the tree as numpy arrays (with or without the
top-level ``"params"`` key); nothing of JAX is imported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from convdr_torch.core.config import EncoderArchConfig, ModelConfig


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _dense(sd, key, tree):
    sd[key + ".weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[key + ".bias"] = _t(tree["bias"])


def _norm(sd, key, tree):
    sd[key + ".weight"] = _t(tree["scale"])
    sd[key + ".bias"] = _t(tree["bias"])


def encoder_tree_to_state_dict(
    tree: Mapping[str, Any], arch: EncoderArchConfig, prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """``TransformerEncoder`` params -> HF-layout keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    emb = prefix + "embeddings."
    sd[emb + "word_embeddings.weight"] = _t(tree["word_embeddings"]["embedding"])
    sd[emb + "position_embeddings.weight"] = _t(
        tree["position_embeddings"]["embedding"]
    )
    if "token_type_embeddings" in tree:
        sd[emb + "token_type_embeddings.weight"] = _t(
            tree["token_type_embeddings"]["embedding"]
        )
    _norm(sd, emb + "LayerNorm", tree["embeddings_norm"])
    for i in range(arch.num_layers):
        lt = tree[f"layer_{i}"]
        p = f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            kern = np.asarray(lt["attention"][name]["kernel"])
            hidden = kern.shape[0]
            sd[p + f"attention.self.{name}.weight"] = _t(kern.reshape(hidden, -1).T)
            sd[p + f"attention.self.{name}.bias"] = _t(
                np.asarray(lt["attention"][name]["bias"]).reshape(-1)
            )
        kout = np.asarray(lt["attention"]["out"]["kernel"])
        hidden = kout.shape[-1]
        sd[p + "attention.output.dense.weight"] = _t(kout.reshape(-1, hidden).T)
        sd[p + "attention.output.dense.bias"] = _t(lt["attention"]["out"]["bias"])
        _norm(sd, p + "attention.output.LayerNorm", lt["attention_norm"])
        _dense(sd, p + "intermediate.dense", lt["intermediate"])
        _dense(sd, p + "output.dense", lt["output"])
        _norm(sd, p + "output.LayerNorm", lt["output_norm"])
    return sd


def flax_params_to_state_dict(
    params_np: Mapping[str, Any], config: ModelConfig
) -> Dict[str, torch.Tensor]:
    """JAX ``AnceEncoder`` / ``DPRBiEncoder`` params (numpy) -> the port's
    ``AnceEncoder`` / ``DPRBiEncoder`` ``state_dict``."""
    p = params_np.get("params", params_np)
    if config.two_tower:
        sd = encoder_tree_to_state_dict(p["question_model"], config.arch, "question_model.")
        sd.update(encoder_tree_to_state_dict(p["ctx_model"], config.arch, "ctx_model."))
        return sd
    sd = encoder_tree_to_state_dict(p["backbone"], config.arch, "roberta.")
    if config.projection_head:
        _dense(sd, "embeddingHead", p["embedding_head"])
        _norm(sd, "norm", p["head_norm"])
    return sd
