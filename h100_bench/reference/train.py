"""The plain KD + ranking train step: the student's conversation embedding
against the frozen teacher's rewrite embedding (MSE) and against the
teacher's documents, the positive first (cross-entropy), then AdamW
(b1 0.9, b2 0.999) after clipping the global gradient norm, with the
learning rate decaying linearly from ``learning_rate`` to 0 at
``total_steps`` (ConvDR's run_convdr_train.py:41-252, in plain PyTorch)."""

from __future__ import annotations

from typing import Dict, List

import torch

from h100_bench.reference.encoder import embed

B1, B2 = 0.9, 0.999


def decayed(name: str) -> bool:
    """Weight decay applies to every leaf but biases and LayerNorm scales."""
    return not (name.endswith(".bias") or name.endswith("LayerNorm.weight")
                or name == "norm.weight")


class PlainTrainer:
    """The student's f32 leaves, the teacher's frozen copy and Adam's
    moments; :meth:`step` takes one batch of device tensors."""

    def __init__(self, cfg: dict, mix: dict, weights: Dict[str, torch.Tensor]):
        self.cfg, self.mix = cfg, mix
        self.student = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
        self.teacher = {n: w.detach().clone() for n, w in weights.items()}
        self.mu = {n: torch.zeros_like(w) for n, w in weights.items()}
        self.nu = {n: torch.zeros_like(w) for n, w in weights.items()}
        self.count = 0
        self.losses: List[float] = []
        # each step's clipped gradient, as a norm a leaf
        self.grad_norms: List[Dict[str, torch.Tensor]] = []

    def loss(self, batch: Dict[str, torch.Tensor], *, rows: slice = slice(None)) -> torch.Tensor:
        cfg = self.cfg
        q = embed(self.student, cfg, batch["concat_ids"][rows], batch["concat_mask"][rows])
        with torch.no_grad():
            t = embed(self.teacher, cfg, batch["target_ids"][rows], batch["target_mask"][rows])
            b, k, length = batch["doc_ids"][rows].shape
            d = embed(self.teacher, cfg, batch["doc_ids"][rows].reshape(b * k, length),
                      batch["doc_mask"][rows].reshape(b * k, length), "body").view(b, k, -1)
        mse = torch.mean(torch.square(q - t))
        logits = torch.einsum("be,bke->bk", q, d)
        return mse - torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])

    def step(self, batch: Dict[str, torch.Tensor], *, rows: slice = slice(None)) -> None:
        """One step; ``rows`` leaves examples out (a planted fault)."""
        mix = self.mix
        loss = self.loss(batch, rows=rows)
        names = list(self.student)
        grads = torch.autograd.grad(loss, [self.student[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(self.student[n]) if g is None else g
                 for n, g in zip(names, grads)]
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = torch.where(norm < mix["max_grad_norm"], torch.ones_like(norm),
                            mix["max_grad_norm"] / norm)
        lr = mix["learning_rate"] * (1.0 - min(self.count, mix["total_steps"]) / mix["total_steps"])
        bc1, bc2 = 1.0 - B1 ** (self.count + 1), 1.0 - B2 ** (self.count + 1)
        norms = {}
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale
                norms[n] = torch.linalg.vector_norm(g)
                mu, nu, p = self.mu[n], self.nu[n], self.student[n]
                mu.mul_(B1).add_((1 - B1) * g)
                nu.mul_(B2).add_((1 - B2) * torch.square(g))
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + mix["adam_epsilon"])
                if decayed(n):
                    upd = upd + mix["weight_decay"] * p
                p.sub_(lr * upd)
        self.count += 1
        self.losses.append(float(loss.detach()))
        self.grad_norms.append(norms)
