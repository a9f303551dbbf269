"""Reference checkpoint files -> this package's ``state_dict``.

The reference's ANCE models are Hugging Face ``save_pretrained`` directories
holding ``pytorch_model.bin`` (or ``model.safetensors``) with keys
``roberta.*``, ``embeddingHead.*`` and ``norm.*`` (model/models.py:129-148;
the JAX package writes the same format with ``export_ance_checkpoint``).
:class:`~convdr_torch.models.encoders.AnceEncoder` uses exactly those keys,
so the file loads as it is. DPR ``CheckpointState`` files are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a file or an HF directory, on the CPU."""
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
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict_checked(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load every parameter the model has from ``sd``; raise on a missing
    key or a shape mismatch. Extra keys (HF pooler, ``position_ids``
    buffers) are ignored."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
