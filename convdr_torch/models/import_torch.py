"""Reference checkpoint files -> this package's ``state_dict``.

The reference's ANCE models are Hugging Face ``save_pretrained`` directories
holding ``pytorch_model.bin`` (or ``model.safetensors``) with keys
``roberta.*``, ``embeddingHead.*`` and ``norm.*`` (model/models.py:129-148;
the JAX package writes the same format with ``export_ance_checkpoint``).
:class:`~convdr_torch.models.encoders.AnceEncoder` uses exactly those keys,
so the file loads as it is.

The dpr models are DPR ``CheckpointState`` files (``torch.save`` of the
namedtuple's ``_asdict()``, weights under ``model_dict``) or HF-style
state dicts, with keys ``question_model.*`` / ``ctx_model.*`` and, in the
reference's BiEncoder, ``bert.`` inside each tower (utils/dpr_utils.py:23-25,
74-78). :func:`dpr_state_dict` strips them as the JAX package's
``import_dpr_checkpoint`` does, into
:class:`~convdr_torch.models.encoders.DPRBiEncoder`'s keys; the port's own
dpr training output (a flat ``DPRBiEncoder.state_dict()``) passes through
unchanged.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

DPR_TOWERS = ("question_model", "ctx_model")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a file or an HF directory, on the CPU; a DPR
    ``CheckpointState`` dict is unwrapped to its ``model_dict``."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"No model weights found under {path}")
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_dict" in sd:
        sd = sd["model_dict"]  # DPR CheckpointState._asdict()
    return sd


def _strip_prefix(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The keys under ``prefix`` with it removed; ``sd`` itself if none is."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out if out else sd


def dpr_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A dpr checkpoint's state dict -> ``DPRBiEncoder`` keys: each tower's
    keys with ``<tower>.`` and then ``bert.`` stripped, filed again under
    ``<tower>.``."""
    out: Dict[str, torch.Tensor] = {}
    for tower in DPR_TOWERS:
        tower_sd = _strip_prefix(_strip_prefix(sd, tower + "."), "bert.")
        out.update({f"{tower}.{k}": v for k, v in tower_sd.items()})
    return out


def load_state_dict_checked(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load every parameter the model has from ``sd``; raise on a missing
    key or a shape mismatch. Extra keys (HF pooler, ``position_ids``
    buffers) are ignored."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
