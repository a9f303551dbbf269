"""Training with dropout in the port (CPU).

torch's generators cannot give JAX's bits, so the port is held to what
dropout must do rather than to the JAX package's draws:

  * at rate 0 the dropout path (the plain attention einsum the JAX package
    takes under attention dropout, and the dropout sites) equals the
    deterministic step within f32 rtol 1e-5 (the same products, summed in
    another order by autograd than by the plain backward);
  * at rate 0.1 a site drops 0.1 +- 0.005 of 2e5 draws and scales the rest
    by 1 / 0.9; one seed repeats a run, another seed changes it; and the
    loss falls over a short run on one batch;
  * without ``use_dropout`` a step leaves the student in ``train()`` mode
    and nothing drops.
"""

import dataclasses

import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.models import attention as ta
from convdr_torch.models import transformer
from convdr_torch.models.transformer import Dropout
from convdr_torch.train import trainer as ttr
from test_torch_train import _batches, _pair, _tiny_model_config


def _models(rate):
    cfg = _tiny_model_config()
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, hidden_dropout=rate, attention_dropout=rate))
    _, _, student = _pair(cfg, 0)
    _, _, teacher = _pair(cfg, 1)
    teacher.requires_grad_(False)
    return student, teacher


def _run(rate, use_dropout, seed=42, steps=1, batches=None, lr=1e-3):
    student, teacher = _models(rate)
    config = tcfg.TrainConfig(learning_rate=lr, ranking_task=True, num_negatives=2,
                              use_dropout=use_dropout, seed=seed)
    state, tx = ttr.create_train_state(student, config, 100)
    step = ttr.make_train_step(student, teacher, tx, config)
    batches = batches or _batches(3, steps)
    losses, grads = [], None
    for i in range(steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batches[i % len(batches)].items()})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in student.named_parameters()}
    return losses, grads, student


def test_rate_zero_dropout_path_equals_the_deterministic_step(monkeypatch):
    want_losses, want_grads, _ = _run(0.0, use_dropout=False)
    # at rate 0 the JAX dispatch keeps flash attention; the dropout path's
    # plain einsum is swapped in to hold it to the deterministic step
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda q, k, v, m: ta.dropout_attention_plain(q, k, v, m, Dropout(0.0)))
    got_losses, got_grads, _ = _run(0.0, use_dropout=True)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for name, g in got_grads.items():
        w = want_grads[name]
        # a key bias's exact gradient is 0 (softmax shift invariance): its
        # scale is its layer's key weight's gradient
        scale = want_grads[name.replace("key.bias", "key.weight")].abs().max()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(scale), err_msg=name)


def test_dropout_attention_plain_with_identity_is_the_plain_attention():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 2, 16).astype(np.float32)) for _ in range(3))
    mask = torch.tensor([[1] * 9, [1] * 4 + [0] * 5], dtype=torch.int32)
    assert torch.equal(ta.dropout_attention_plain(q, k, v, mask, lambda p: p),
                       ta.flash_attention_plain(q, k, v, mask))


def test_drop_share_and_scale_at_rate_0_1():
    drop = Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(0)
    out = drop(torch.ones(200_000))
    share = float((out == 0).float().mean())
    assert abs(share - 0.1) <= 0.005, share
    kept = out[out != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.9))
    drop.eval()
    assert torch.equal(drop(torch.ones(8)), torch.ones(8))


def test_one_seed_repeats_a_run_and_another_changes_it():
    a, _, _ = _run(0.1, use_dropout=True, seed=1, steps=3)
    b, _, _ = _run(0.1, use_dropout=True, seed=1, steps=3)
    c, _, _ = _run(0.1, use_dropout=True, seed=2, steps=3)
    d, _, _ = _run(0.1, use_dropout=False, steps=3)
    assert a == b
    assert a != c and a != d
    assert all(np.isfinite(a + c))


def test_loss_falls_with_dropout_on():
    losses, _, _ = _run(0.1, use_dropout=True, steps=30, batches=_batches(4, 1))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses


@pytest.mark.parametrize("use_dropout", [False, True])
def test_a_step_leaves_train_mode_but_nothing_drops(use_dropout):
    _, _, student = _run(0.1, use_dropout=use_dropout)
    assert student.training
    ids = torch.randint(4, 60, (2, 12), generator=torch.Generator().manual_seed(0))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        in_train = student.query_emb(ids, mask)
        student.eval()
        assert torch.equal(in_train, student.query_emb(ids, mask))
