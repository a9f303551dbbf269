"""Checkpoints: the port's ``train_state.pt`` and the JAX package's orbax dirs.

The port's own format is the counterpart of ``convdr_tpu/train/
checkpoint.py`` (an orbax tree of ``{params, opt_state, step}`` there) in a
torch format: ``torch.save`` of ``{"model": state_dict, "opt_state": ...,
"step": micro_steps}`` into ``<dir>/train_state.pt``, with the same
``convdr_meta.json`` side file and ``checkpoint-N`` naming. Resume is exact:
the restored run continues with the same parameters, moments, counts and
accumulation buffers.

The JAX package's orbax checkpoints are read and written here too, with no
orbax or tensorstore: ``_METADATA`` (JSON) names every leaf of the tree by
its path, each array is a zarr v2 array (:mod:`convdr_torch.utils.zarr2`)
in the OCDBT store at the dir's root (:mod:`convdr_torch.utils.ocdbt`),
keyed by the path joined with ``"."``. :func:`read_orbax_tree` rebuilds the
tree; :func:`save_orbax_checkpoint` writes one that the JAX package's
``restore_checkpoint`` reads. :func:`restore_checkpoint` takes a JAX
``checkpoint-N`` (a TrainState: ``[params, opt_state, step]``) or
``final/`` (bare params) as it takes the port's own, through the mappings
of :mod:`convdr_torch.models.from_jax`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from convdr_torch.core.loading import resolve_orbax_dir
from convdr_torch.train.trainer import TrainState

STATE_FILE = "train_state.pt"
META_FILE = "convdr_meta.json"
ORBAX_METADATA = "_METADATA"
ORBAX_CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
# orbax's key types in _METADATA: a sequence index, a dict key
_SEQUENCE, _DICT = 1, 2
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


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
    _write_metadata(path, metadata)


def _write_metadata(path: str, metadata: Optional[dict]) -> None:
    if metadata is not None:
        with open(os.path.join(path, META_FILE), "w") as f:
            json.dump(metadata, f)


# ---------------------------------------------------------------- orbax
def _orbax_metadata(path: str) -> dict:
    meta_path = os.path.join(path, ORBAX_METADATA)
    if not os.path.exists(meta_path):
        raise ValueError(f"{path} holds no orbax {ORBAX_METADATA}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 orbax checkpoints are not supported (zarr v2 only)")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: orbax checkpoints without OCDBT are not supported")
    return meta


def read_orbax_tree(path: str) -> Any:
    """The tree of the orbax checkpoint at ``path`` (or its ``final/``):
    dicts for dict keys, lists for sequence indices, CPU tensors for arrays
    and ``None`` for the entries orbax skips (empty optimizer states)."""
    from convdr_torch.utils.ocdbt import OcdbtReader
    from convdr_torch.utils.zarr2 import read_array

    path = resolve_orbax_dir(path) or path
    meta = _orbax_metadata(path)
    reader = OcdbtReader(path)
    root: Dict = {}
    try:
        for entry in meta["tree_metadata"].values():
            keys = entry["key_metadata"]
            for k in keys:
                if k["key_type"] not in (_SEQUENCE, _DICT):
                    raise ValueError(
                        f"{path}: key type {k['key_type']} of {k['key']!r} is not supported")
            value = entry["value_metadata"]
            leaf = (None if value.get("skip_deserialize")
                    else read_array(reader, ".".join(str(k["key"]) for k in keys)))
            node = root
            for k in keys[:-1]:
                node = node.setdefault((k["key_type"], str(k["key"])), {})
            node[(keys[-1]["key_type"], str(keys[-1]["key"]))] = leaf
    finally:
        reader.close()
    return _as_tree(root)


def _as_tree(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(kt == _SEQUENCE for kt, _ in node):
        items = sorted((int(k), v) for (_, k), v in node.items())
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"orbax sequence indices {[i for i, _ in items]} have gaps")
        return [_as_tree(v) for _, v in items]
    if any(kt == _SEQUENCE for kt, _ in node):
        raise ValueError("an orbax tree node mixes sequence indices and dict keys")
    return {k: _as_tree(v) for (_, k), v in node.items()}


def orbax_leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path of (key type, key)), leaf] of a tree: tensors, ``None`` and
    empty tuples are leaves."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in orbax_leaves(v, path + ((_DICT, str(k)),))]
    if isinstance(tree, (list, tuple)) and len(tree):
        return [x for i, v in enumerate(tree)
                for x in orbax_leaves(v, path + ((_SEQUENCE, str(i)),))]
    return [(path, tree)]


def save_orbax_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` (nested dicts and lists of tensors; ``None`` for an
    empty optimizer state, ``()`` for an empty tuple) as the orbax
    checkpoint that the JAX package's ``save_checkpoint`` writes: the same
    ``_METADATA`` paths, ``_CHECKPOINT_METADATA``, ``convdr_meta.json`` and
    one zarr v2 array per tensor in an OCDBT store. Overwrites a checkpoint
    at ``path``."""
    import shutil

    from convdr_torch.utils.ocdbt import write_ocdbt
    from convdr_torch.utils.zarr2 import array_items

    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    start = time.time_ns()
    tree_meta, items = {}, []
    for keys, leaf in orbax_leaves(tree):
        name = "(" + ", ".join(repr(k) for _, k in keys) + ("," if len(keys) == 1 else "") + ")"
        if isinstance(leaf, torch.Tensor):
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
            items += array_items(".".join(k for _, k in keys), leaf)
        elif leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        elif isinstance(leaf, tuple):  # an empty tuple (non-empty ones are nodes)
            value = {"value_type": "Tuple", "skip_deserialize": True}
        else:
            raise ValueError(f"orbax writer: leaf {name} of type {type(leaf)} is not supported")
        tree_meta[name] = {"key_metadata": [{"key": k, "key_type": t} for t, k in keys],
                           "value_metadata": value}
    write_ocdbt(path, items)
    with open(os.path.join(path, ORBAX_METADATA), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    _write_metadata(path, metadata)
    with open(os.path.join(path, ORBAX_CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def orbax_tree_of(state: Union[TrainState, nn.Module], weight_decay: float = 0.0) -> Any:
    """The JAX package's tree for a port TrainState (``[params, opt_state,
    step]``, its optax state per ``weight_decay``, see
    :func:`~convdr_torch.models.from_jax.opt_state_to_jax`) or a bare
    model (``{"params": ...}``)."""
    from convdr_torch.models.from_jax import opt_state_to_jax, state_dict_to_flax

    model = state.model if isinstance(state, TrainState) else state
    params = state_dict_to_flax(model.state_dict(), model.config)
    if not isinstance(state, TrainState):
        return params
    return [params, opt_state_to_jax(state.opt_state, model.config, weight_decay),
            torch.tensor(state.step, dtype=torch.int32)]


def load_orbax_params(model: nn.Module, params: Any, where: str) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` from a JAX ``{"params": ...}`` tree;
    raises ``ValueError`` naming the first missing or extra key, or a shape
    that differs. Word-embedding tables may be shorter (the caller grows
    them)."""
    from convdr_torch.models.from_jax import flax_params_to_state_dict, state_dict_to_flax

    def shapes(tree):
        return {"/".join(k for _, k in keys): (tuple(v.shape) if hasattr(v, "shape") else None)
                for keys, v in orbax_leaves(tree)}

    want = shapes(state_dict_to_flax(model.state_dict(), model.config))
    got = shapes(params) if isinstance(params, dict) else {"<root>": None}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        first = (f"missing key {missing[0]!r} ({want[missing[0]]})" if missing
                 else f"extra key {extra[0]!r} ({got[extra[0]]})")
        raise ValueError(f"the orbax tree at {where} does not fit the "
                         f"{model.config.name} model: {first}; {len(missing)} missing, "
                         f"{len(extra)} extra")
    for key, shape in want.items():
        ok = got[key] == shape or (key.endswith("word_embeddings/embedding") and got[key]
                                   and got[key][1:] == shape[1:] and got[key][0] <= shape[0])
        if not ok:
            raise ValueError(f"the orbax tree at {where} does not fit the {model.config.name} "
                             f"model: {key!r} has shape {got[key]}, the model {shape}")
    return flax_params_to_state_dict(params, model.config)


def restore_checkpoint(path: str, template: Union[TrainState, nn.Module]):
    """Load a checkpoint of :func:`save_checkpoint`, or a JAX orbax
    checkpoint, into ``template`` (its model's device) and return it."""
    model = template.model if isinstance(template, TrainState) else template
    device = next(model.parameters()).device
    if not os.path.exists(os.path.join(path, STATE_FILE)) and resolve_orbax_dir(path):
        return _restore_orbax(path, template, model, device)
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    model.load_state_dict(payload["model"])
    if isinstance(template, TrainState):
        template.opt_state = payload["opt_state"]
        template.step = int(payload["step"])
    return template


def _restore_orbax(path: str, template, model: nn.Module, device: torch.device):
    from convdr_torch.models.from_jax import opt_state_from_jax

    tree = read_orbax_tree(path)
    train_state = isinstance(template, TrainState)
    if train_state != isinstance(tree, list):
        raise ValueError(
            f"{path} holds {'a TrainState' if isinstance(tree, list) else 'bare params'}, "
            f"expected {'a TrainState' if train_state else 'bare params'}")
    if train_state and len(tree) != 3:
        raise ValueError(f"{path}: a TrainState has 3 entries, this tree {len(tree)}")
    # each part is dropped once it is on the model, so the host holds the
    # decoded tree and at most one part's transposed copies
    params = tree[0] if train_state else tree
    if train_state:
        tree[0] = None
    sd = load_orbax_params(model, params, path)
    del params
    model.load_state_dict({k: v.to(device) for k, v in sd.items()})
    del sd
    if not train_state:
        return template
    opt = opt_state_from_jax(tree[1], model.config)
    tree[1] = None
    if ("mini_step" in opt) != ("mini_step" in template.opt_state):
        raise ValueError(
            f"{path}: the checkpoint's optimizer {'accumulates' if 'mini_step' in opt else 'does not accumulate'} "
            "gradients, the configured one "
            f"{'does' if 'mini_step' in template.opt_state else 'does not'}")
    for group in ("mu", "nu", "acc"):
        if group in opt:
            opt[group] = {k: v.to(device) for k, v in opt[group].items()}
    template.opt_state = opt
    template.step = int(tree[2].item())
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
