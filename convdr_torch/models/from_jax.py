"""The JAX package's parameter and optimizer trees <-> this package's.

Inverts the layout that ``convdr_tpu/models/import_torch.py::
hf_encoder_to_flax`` builds: ``DenseGeneral`` q/k/v kernels
``[hidden, heads, head_dim]`` and the attention output kernel
``[heads, head_dim, hidden]`` become ``Linear.weight [out, in]``, ``Dense``
kernels ``[in, out]`` are transposed, and LayerNorm ``scale`` becomes
``weight``. The input is the tree as numpy arrays or CPU tensors (with or
without the top-level ``"params"`` key); nothing of JAX is imported.
:func:`state_dict_to_flax` is the inverse, bit for bit.

The optax state of the JAX package's optimizer (``convdr_tpu/train/
optimizer.py``: ``chain(clip_by_global_norm, adamw)``, inside
``MultiSteps`` when accumulating) maps onto :class:`~convdr_torch.train.
optimizer.ClipAdamW`'s state by :func:`opt_state_from_jax` and back by
:func:`opt_state_to_jax`. The trees are the ones orbax restores, with
sequences as lists and ``None`` for the empty states:

    [None,                                      # clip_by_global_norm
     [{"count", "mu", "nu"},                    # scale_by_adam
      None or {"inner_state": None},            # (masked) weight decay
      {"count"}]]                               # the schedule's count

and with accumulation ``{"mini_step", "gradient_step", "inner_opt_state":
<that chain>, "acc_grads": <params tree>, "skip_state"}``. Adam is
elementwise, so moving ``mu``, ``nu`` and the accumulated gradients through
the parameters' transposes is exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from convdr_torch.core.config import EncoderArchConfig, ModelConfig


def _t(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):  # no copy: the caller owns the tree
        return arr.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _dense(sd, key, tree):
    sd[key + ".weight"] = _t(tree["kernel"]).T.contiguous()
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
            kern = _t(lt["attention"][name]["kernel"])
            hidden = kern.shape[0]
            sd[p + f"attention.self.{name}.weight"] = kern.reshape(hidden, -1).T.contiguous()
            sd[p + f"attention.self.{name}.bias"] = _t(lt["attention"][name]["bias"]).reshape(-1)
        kout = _t(lt["attention"]["out"]["kernel"])
        hidden = kout.shape[-1]
        sd[p + "attention.output.dense.weight"] = kout.reshape(-1, hidden).T.contiguous()
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


# ---------------------------------------------------------------- inverse
def _kernel(w: torch.Tensor) -> torch.Tensor:
    return w.detach().to("cpu").T.contiguous()


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def state_dict_to_encoder_tree(
    sd: Mapping[str, torch.Tensor], arch: EncoderArchConfig, prefix: str = ""
) -> Dict[str, Any]:
    """Inverse of :func:`encoder_tree_to_state_dict` (CPU tensors)."""
    emb = prefix + "embeddings."
    tree: Dict[str, Any] = {
        "word_embeddings": {"embedding": _plain(sd[emb + "word_embeddings.weight"])},
        "position_embeddings": {"embedding": _plain(sd[emb + "position_embeddings.weight"])},
        "embeddings_norm": {"scale": _plain(sd[emb + "LayerNorm.weight"]),
                            "bias": _plain(sd[emb + "LayerNorm.bias"])},
    }
    if emb + "token_type_embeddings.weight" in sd:
        tree["token_type_embeddings"] = {
            "embedding": _plain(sd[emb + "token_type_embeddings.weight"])}
    heads = arch.num_heads
    for i in range(arch.num_layers):
        p = f"{prefix}encoder.layer.{i}."

        def norm(key):
            return {"scale": _plain(sd[key + ".weight"]), "bias": _plain(sd[key + ".bias"])}

        def dense(key):
            return {"kernel": _kernel(sd[key + ".weight"]), "bias": _plain(sd[key + ".bias"])}

        attn = {}
        for name in ("query", "key", "value"):
            w = _kernel(sd[p + f"attention.self.{name}.weight"])  # [hidden, hidden]
            attn[name] = {"kernel": w.reshape(w.shape[0], heads, -1),
                          "bias": _plain(sd[p + f"attention.self.{name}.bias"]).reshape(heads, -1)}
        wo = _kernel(sd[p + "attention.output.dense.weight"])
        attn["out"] = {"kernel": wo.reshape(heads, -1, wo.shape[-1]),
                       "bias": _plain(sd[p + "attention.output.dense.bias"])}
        tree[f"layer_{i}"] = {
            "attention": attn,
            "attention_norm": norm(p + "attention.output.LayerNorm"),
            "intermediate": dense(p + "intermediate.dense"),
            "output": dense(p + "output.dense"),
            "output_norm": norm(p + "output.LayerNorm"),
        }
    return tree


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], config: ModelConfig) -> Dict[str, Any]:
    """The port's ``state_dict`` -> the JAX package's ``{"params": ...}``
    tree (CPU tensors), the inverse of :func:`flax_params_to_state_dict`."""
    if config.two_tower:
        p = {"question_model": state_dict_to_encoder_tree(sd, config.arch, "question_model."),
             "ctx_model": state_dict_to_encoder_tree(sd, config.arch, "ctx_model.")}
    else:
        p = {"backbone": state_dict_to_encoder_tree(sd, config.arch, "roberta.")}
        if config.projection_head:
            p["embedding_head"] = {"kernel": _kernel(sd["embeddingHead.weight"]),
                                   "bias": _plain(sd["embeddingHead.bias"])}
            p["head_norm"] = {"scale": _plain(sd["norm.weight"]), "bias": _plain(sd["norm.bias"])}
    return {"params": p}


# ---------------------------------------------------------------- optimizer
def _count(x) -> int:
    return int(x.item() if isinstance(x, torch.Tensor) else np.asarray(x).item())


def _scalar(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def opt_state_from_jax(tree: Any, config: ModelConfig) -> dict:
    """The JAX package's optax state (as orbax restores it, see the module
    docstring) -> :class:`ClipAdamW`'s state dict. Checks that Adam's count
    equals the schedule's and, under ``MultiSteps``, the gradient step."""
    multi = isinstance(tree, Mapping) and "inner_opt_state" in tree
    chain = tree["inner_opt_state"] if multi else tree
    try:
        adam, sched = chain[1][0], chain[1][2]
        count = _count(adam["count"])
        sched_count = _count(sched["count"])
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(
            "the optimizer state is not the JAX package's clip_by_global_norm + adamw "
            f"chain: {e!r}") from e
    if count != sched_count:
        raise ValueError(f"Adam's count {count} differs from the schedule's {sched_count}")
    state = {"count": count,
             "mu": flax_params_to_state_dict(adam["mu"], config),
             "nu": flax_params_to_state_dict(adam["nu"], config)}
    if multi:
        gradient_step = _count(tree["gradient_step"])
        if gradient_step != count:
            raise ValueError(
                f"MultiSteps' gradient_step {gradient_step} differs from Adam's count {count}")
        state["mini_step"] = _count(tree["mini_step"])
        state["acc"] = flax_params_to_state_dict(tree["acc_grads"], config)
    return state


def opt_state_to_jax(state: dict, config: ModelConfig, weight_decay: float) -> Any:
    """Inverse of :func:`opt_state_from_jax`: the tree orbax writes for the
    JAX package's optimizer with the same accumulation (``"mini_step"`` in
    ``state``) and weight decay (masked when ``weight_decay > 0``, as
    ``convdr_tpu/train/optimizer.py`` builds it). ``skip_state`` is ``()``."""
    count = _scalar(state["count"])
    chain = [None, [
        {"count": count,
         "mu": state_dict_to_flax(state["mu"], config),
         "nu": state_dict_to_flax(state["nu"], config)},
        {"inner_state": None} if weight_decay > 0 else None,
        {"count": _scalar(state["count"])},
    ]]
    if "mini_step" not in state:
        return chain
    return {"mini_step": _scalar(state["mini_step"]),
            "gradient_step": _scalar(state["count"]),
            "inner_opt_state": chain,
            "acc_grads": state_dict_to_flax(state["acc"], config),
            "skip_state": ()}
