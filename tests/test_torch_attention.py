"""convdr_torch attention against the JAX package's naive attention (CPU).

The JAX naive path masks pad keys with a -1e9 bias for every query; the
segment-id semantics of the flash kernels let pads attend to pads. The two
agree on valid query positions, which are the only ones compared (the
pooled outputs never read pad positions). Tolerance 1e-5 absolute in f32:
the same softmax in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.models import attention as torch_attn
from convdr_tpu.models.attention import naive_attention


def _problem(seed, b, t, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, mask


def _jax_naive(q, k, v, mask):
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    return np.asarray(naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.float32,
    ))


@pytest.mark.parametrize(
    "b,t,h,d,lengths",
    [
        (3, 16, 2, 16, [16, 5, 0]),       # ragged, with an all-pad row
        (2, 37, 3, 32, [37, 1]),          # T not a tile multiple
        (4, 64, 12, 64, [64, 63, 20, 2]),  # base-model head shape
        (1, 256, 4, 64, [111]),           # the serving encode (a served history)
        (4, 64, 2, 64, [64, 40, 9, 1]),   # the teacher's targets
    ],
)
def test_plain_flash_matches_jax_naive_on_valid_positions(b, t, h, d, lengths):
    q, k, v, mask = _problem(0, b, t, h, d, lengths)
    before = torch_attn.flash_attention.launches
    out = torch_attn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    ).numpy()
    # CPU tensors take the plain version; the kernel never launches
    assert torch_attn.flash_attention.launches == before
    assert np.isfinite(out).all()
    ref = _jax_naive(q, k, v, mask)
    valid = mask.astype(bool)
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-5, rtol=0)


def test_all_pad_row_attends_only_to_pads():
    """Segment semantics: a pad query averages over pad keys only."""
    q, k, v, mask = _problem(1, 1, 8, 1, 16, [3])
    out = torch_attn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask),
    ).numpy()
    s = q[0, 5, 0] @ k[0, 3:, 0].T / 4.0
    p = np.exp(s - s.max())
    p /= p.sum()
    np.testing.assert_allclose(out[0, 5, 0], p @ v[0, 3:, 0], atol=1e-5)
