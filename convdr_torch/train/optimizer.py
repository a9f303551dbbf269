"""Optimizer: the JAX package's optax chain, written out in torch.

The counterpart of ``convdr_tpu/train/optimizer.py``: global-norm clipping
at ``max_grad_norm`` (reference run_convdr_train.py:188-189), then AdamW
(b1 0.9, b2 0.999) with weight decay masked off biases and LayerNorm scales
(reference dpr_utils.py:80-87) under a linear warmup/decay schedule
(run_convdr_train.py:71-74), wrapped in gradient accumulation when
``gradient_accumulation_steps > 1``. Each stage follows the optax function
it replaces, in its order of operations:

  * ``optax.clip_by_global_norm``: ``g / norm * max`` when ``norm >= max``,
    ``g`` otherwise (not torch's ``clip_grad_norm_``, which scales by
    ``max / (norm + 1e-6)`` always);
  * ``optax.adamw``: moments ``(1 - b) * g + b * m``, bias correction by
    ``1 - b**count``, ``m / (sqrt(v) + eps)``, ``+ weight_decay * p`` on
    the decayed parameters, times ``-lr(count)`` with the schedule read at
    the update count *before* it is incremented;
  * ``optax.MultiSteps``: the running mean of ``k`` micro-step gradients
    (``acc + (g - acc) / (n + 1)``) feeds one inner update every ``k``
    micro-steps; the inner count and the schedule advance once per ``k``.

State is a plain dict of tensors and ints (``torch.save``-able), updated in
place with the parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
from torch import nn

from convdr_torch.core.config import TrainConfig

B1, B2 = 0.9, 0.999


def linear_warmup_decay(
    learning_rate: float, warmup_steps: int, total_steps: int
) -> Callable[[int], float]:
    """0 -> lr over warmup, then lr -> 0 at total_steps (HF linear schedule),
    evaluated as ``optax.join_schedules`` of two ``linear_schedule``s: the
    decay takes over at ``count == warmup_steps``, so with no warmup the
    first update uses the full rate."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warm) / warm
            return (0.0 - learning_rate) * frac + learning_rate
        frac = 1.0 - min(max(count - warmup_steps, 0), decay) / decay
        return learning_rate * frac

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies. No decay for every
    ``bias`` and every LayerNorm's weight (the JAX mask's ``bias`` and
    ``scale`` leaves), chosen by module type: the ANCE head's ``norm`` is a
    LayerNorm whose name holds no "LayerNorm"."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = not (name == "bias" or isinstance(mod, nn.LayerNorm))
    return mask


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


class ClipAdamW:
    """clip_by_global_norm -> AdamW, optionally inside gradient accumulation.

    ``decay`` maps parameter names to whether weight decay applies (see
    :func:`decay_mask`).
    """

    def __init__(self, config: TrainConfig, total_steps: int, decay: Dict[str, bool]):
        self.schedule = linear_warmup_decay(
            config.learning_rate, config.warmup_steps, total_steps
        )
        self.max_grad_norm = config.max_grad_norm
        self.eps = config.adam_epsilon
        self.weight_decay = config.weight_decay
        self.k = config.gradient_accumulation_steps
        self.decay = decay

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in params.items()}

        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.k > 1:
            state.update(mini_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> None:
        """Take one micro-step's gradients; update ``params`` and ``state``
        in place (the parameters move on every k-th call)."""
        if self.k == 1:
            self._inner(grads, state, params)
            return
        n = state["mini_step"]
        for name, g in grads.items():
            acc = state["acc"][name]
            acc.copy_(acc + (g - acc) / (n + 1))
        if n < self.k - 1:
            state["mini_step"] = n + 1
            return
        self._inner(state["acc"], state, params)
        for acc in state["acc"].values():
            acc.zero_()
        state["mini_step"] = 0

    def _inner(self, grads, state, params) -> None:
        norm = global_norm(grads.values())
        keep = norm < self.max_grad_norm
        count = state["count"]
        lr = self.schedule(count)
        bc1 = 1.0 - B1 ** (count + 1)
        bc2 = 1.0 - B2 ** (count + 1)
        for name, g in grads.items():
            p, mu, nu = params[name], state["mu"][name], state["nu"][name]
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * torch.square(g) + B2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay and self.decay[name]:
                upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
        state["count"] = count + 1


def make_optimizer(config: TrainConfig, total_steps: int, model: nn.Module) -> ClipAdamW:
    """The optimizer for ``model``'s parameters, its decay mask taken from
    their module types."""
    return ClipAdamW(config, total_steps, decay_mask(model))
