"""The port's attention gradient on the CPU.

``flash_attention_bwd_plain`` is the formula the CUDA backward kernel is
held to on the card; here it is held to ``torch.autograd`` of the plain
forward and to ``jax.grad`` of the JAX package's naive attention (the JAX
CPU path; its flash kernel runs only on a TPU). The JAX path lets pad
queries attend to valid keys, the port's segment rule lets them see pads
only, so against JAX the upstream gradient is zero at pad queries, which is
what a model gives (pooling never reads pad positions). Tolerance 1e-5
absolute in f32: the same products in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.models import attention as ta
from convdr_tpu.models.attention import naive_attention

SHAPES = [
    (3, 16, 2, 16, [16, 5, 0]),        # ragged, with an all-pad row
    (2, 37, 3, 32, [37, 1]),           # T not a tile multiple
    (4, 64, 12, 64, [64, 63, 20, 2]),  # base-model head shape
    # the card's tile cuts: 64-row blocks and 32-row tiles cut by T
    (5, 200, 12, 64, [200, 131, 64, 33, 1]),
    (2, 513, 2, 64, [513, 257]),
]


def _problem(seed, b, t, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,t,h,d,lengths", SHAPES)
def test_bwd_plain_matches_autograd_of_plain_forward(b, t, h, d, lengths):
    q, k, v, do, mask = _torch(*_problem(0, b, t, h, d, lengths))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ta.flash_attention_plain(*leaves, mask)
    want = torch.autograd.grad(out, leaves, do)
    got = ta.flash_attention_bwd_plain(q, k, v, out.detach(), do, mask)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t,h,d,lengths", SHAPES)
def test_bwd_plain_matches_jax_grad_of_naive_attention(b, t, h, d, lengths):
    q, k, v, do, mask = _problem(1, b, t, h, d, lengths)
    do = do * mask[:, :, None, None]  # pad queries never reach the loss
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)

    def f(q_, k_, v_):
        out = naive_attention(q_, k_, v_, jnp.asarray(bias), jnp.float32)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo, tmask = _torch(q, k, v, do, mask)
    out = ta.flash_attention_plain(tq, tk, tv, tmask)
    got = ta.flash_attention_bwd_plain(tq, tk, tv, out, tdo, tmask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_flash_attention_fn_on_cpu_takes_the_plain_formula():
    q, k, v, do, mask = _torch(*_problem(2, 3, 16, 2, 16, [16, 5, 0]))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = ta.flash_attention.launches, ta.flash_attention_bwd.launches
    out = ta.flash_attention(*leaves, mask)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    # CPU tensors never launch a kernel
    assert (ta.flash_attention.launches, ta.flash_attention_bwd.launches) == (fwd, bwd)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ta.flash_attention_plain(q, k, v, mask).numpy())
    want = ta.flash_attention_bwd_plain(q, k, v, out.detach(), do, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_flash_attention_records_no_graph_without_grad():
    q, k, v, _do, mask = _torch(*_problem(3, 2, 8, 2, 16, [8, 3]))
    assert ta.flash_attention(q, k, v, mask).grad_fn is None
    with torch.no_grad():
        out = ta.flash_attention(q.requires_grad_(), k, v, mask)
    assert out.grad_fn is None



# ---------------- bf16 ----------------
def _bf16_problem(seed, b, t, h, d, lengths):
    q, k, v, do, mask = _problem(seed, b, t, h, d, lengths)
    do = (do * mask[:, :, None, None]).astype(np.float32)  # pad queries never reach the loss
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v, do)]
    return (*bf, mask)


def _jax_bf16_grads(q, k, v, do, mask):
    """jax.grad of the JAX package's naive attention in bf16 (its CPU path)."""
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)

    def f(q_, k_, v_):
        out = naive_attention(q_, k_, v_, jnp.asarray(bias), jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _assert_bf16_close(got, want, mask):
    """At valid positions (pads differ by design and never reach a loss):
    within 1e-2 of each gradient's largest entry, the bf16 error of two
    roundings of the same f32 sums (the JAX path rounds P and dP to bf16,
    the port's plain version keeps them in f32)."""
    valid = mask.astype(bool)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[valid], w[valid], atol=1e-2 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("b,t,h,d,lengths", SHAPES)
def test_bf16_bwd_plain_matches_jax_grad_of_naive_attention(b, t, h, d, lengths):
    q, k, v, do, mask = _bf16_problem(4, b, t, h, d, lengths)
    want = _jax_bf16_grads(q, k, v, do, mask)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    tmask = torch.from_numpy(mask)
    out = ta.flash_attention_plain(tq, tk, tv, tmask)
    got = ta.flash_attention_bwd_plain(tq, tk, tv, out, tdo, tmask)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_bf16_close(got, want, mask)


@pytest.mark.parametrize("b,t,h,d,lengths", SHAPES)
def test_bf16_flash_attention_fn_matches_jax_grad_of_naive_attention(b, t, h, d, lengths):
    q, k, v, do, mask = _bf16_problem(5, b, t, h, d, lengths)
    want = _jax_bf16_grads(q, k, v, do, mask)
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = ta.flash_attention(*leaves, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    _assert_bf16_close(got, want, mask)
