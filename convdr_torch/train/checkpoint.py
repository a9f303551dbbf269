"""Checkpoints: one file for the student, the optimizer state and the step.

The counterpart of ``convdr_tpu/train/checkpoint.py`` (an orbax tree of
``{params, opt_state, step}`` there) in a torch format: ``torch.save`` of
``{"model": state_dict, "opt_state": ..., "step": micro_steps}`` into
``<dir>/train_state.pt``, with the same ``convdr_meta.json`` side file and
``checkpoint-N`` naming. Resume is exact: the restored run continues with
the same parameters, moments, counts and accumulation buffers.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import torch
from torch import nn

from convdr_torch.train.trainer import TrainState

STATE_FILE = "train_state.pt"
META_FILE = "convdr_meta.json"


def save_checkpoint(path: str, state: Union[TrainState, nn.Module],
                    metadata: Optional[dict] = None) -> None:
    """Save a TrainState (or a bare model) to the directory ``path``,
    overwriting an existing checkpoint there."""
    os.makedirs(path, exist_ok=True)
    if isinstance(state, TrainState):
        payload = {"model": state.model.state_dict(), "opt_state": state.opt_state,
                   "step": state.step}
    else:
        payload = {"model": state.state_dict()}
    target = os.path.join(path, STATE_FILE)
    torch.save(payload, target + ".tmp")
    os.replace(target + ".tmp", target)
    if metadata is not None:
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(metadata, f)


def restore_checkpoint(path: str, template: Union[TrainState, nn.Module]):
    """Load a checkpoint of :func:`save_checkpoint` into ``template`` (its
    model's device) and return it."""
    model = template.model if isinstance(template, TrainState) else template
    device = next(model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    model.load_state_dict(payload["model"])
    if isinstance(template, TrainState):
        template.opt_state = payload["opt_state"]
        template.step = int(payload["step"])
    return template


def load_metadata(path: str) -> Optional[dict]:
    meta = os.path.join(os.path.abspath(path), META_FILE)
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return None


def latest_checkpoint(output_dir: str, prefix: str = "checkpoint-") -> Optional[str]:
    """The highest-step ``checkpoint-N`` directory under ``output_dir``."""
    if not os.path.isdir(output_dir):
        return None
    best, best_no = None, -1
    for name in os.listdir(output_dir):
        if name.startswith(prefix):
            try:
                no = int(name[len(prefix):])
            except ValueError:
                continue
            if no > best_no:
                best, best_no = os.path.join(output_dir, name), no
    return best
