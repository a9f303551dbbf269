"""convdr_torch's bf16 attention against the JAX package's bf16 attention (CPU).

The bf16 kernel (``csrc/flash_attention.cu``) is held on the card to one
bf16 ulp of the port's plain version, which computes softmax and P V in f32
from the bf16 operands and rounds once. The JAX package's bf16 attention
(``convdr_tpu/models/attention.py::naive_attention``, and the Pallas TPU
kernel, which does the same at ``p.astype(v.dtype)``) rounds P to bf16
before P V. Here, on seeded inputs, both are compared with an f64 witness
(the plain version in f64 on the same bf16 values) on valid positions:

* the port is within one bf16 ulp of the witness, above an absolute floor
  of 1e-6 (the card tests' floor: where an output cancels to near zero,
  f32 sums of up to T terms carry errors of that size: the B=2 T=512 case
  below has one output of 1.6e-6 that the f32 sums miss by 2.3 ulps);
* the JAX package's bf16 attention misses that at about a fifth of the
  outputs, so its largest error is larger than the port's. This is why the
  kernel feeds P into P V as three bf16 parts (all 24 bits of an f32 P)
  and not as one.

Also the pure helpers of ``convdr_torch/scripts/attention_sweep.py`` that
its bf16 part reports with: the in-segment pairs of a mask, the kernel's
operations count, the bound, and the distance in bf16 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.models import attention as torch_attn
from convdr_torch.scripts import attention_sweep as sweep
from convdr_tpu.models.attention import naive_attention

FLOOR = 1e-6

# (B, T, H, D, lengths): the corpus encoder's longest rung at two heads, a
# T that is no tile multiple, the small head dims, and short rows
CASES = [
    (2, 512, 2, 64, [512, 300]),
    (2, 384, 2, 64, [384, 2]),
    (2, 128, 2, 32, [128, 77]),
    (3, 200, 2, 16, [200, 131, 1]),
    (4, 64, 2, 64, [64, 40, 9, 1]),
]


def _problem(seed, b, t, h, d, lengths):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).bfloat16()
               for _ in range(3))
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, torch.from_numpy(mask)


def _bf16_ulp(w):
    """One bf16 ulp at each value of ``w`` (8 significant bits)."""
    a = np.abs(w)
    return 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7)


def _errors(seed, b, t, h, d, lengths):
    """|port - f64|, |JAX bf16 - f64| and one ulp of the f64 witness, on
    valid positions."""
    q, k, v, mask = _problem(seed, b, t, h, d, lengths)
    before = torch_attn.flash_attention.launches
    port = torch_attn.flash_attention(q, k, v, mask)
    assert torch_attn.flash_attention.launches == before  # CPU: the plain version
    assert port.dtype == torch.bfloat16
    witness = torch_attn.flash_attention_plain(q.double(), k.double(), v.double(), mask).numpy()
    bias = np.where(mask.numpy()[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    jax_out = naive_attention(jq, jk, jv, jnp.asarray(bias), jnp.bfloat16)
    jax_out = np.asarray(jax_out.astype(jnp.float32)).astype(np.float64)
    valid = mask.numpy().astype(bool)
    port = port.double().numpy()
    return (np.abs(port - witness)[valid], np.abs(jax_out - witness)[valid],
            _bf16_ulp(witness)[valid])


@pytest.mark.parametrize("b,t,h,d,lengths", CASES)
def test_bf16_port_within_one_ulp_of_f64(b, t, h, d, lengths):
    port_err, _jax_err, ulp = _errors(0, b, t, h, d, lengths)
    assert bool(np.all(port_err <= ulp + FLOOR))


@pytest.mark.parametrize("b,t,h,d,lengths", CASES)
def test_bf16_port_no_worse_than_jax_bf16(b, t, h, d, lengths):
    port_err, jax_err, ulp = _errors(0, b, t, h, d, lengths)
    assert port_err.max() <= jax_err.max()
    assert (port_err / ulp).max() <= (jax_err / ulp).max()
    # P rounded to one bf16 misses one ulp (above the floor) somewhere
    assert np.mean(jax_err > ulp + FLOOR) > 0.05


def test_in_segment_pairs_counts_each_segment_squared():
    rng = np.random.RandomState(3)
    mask = torch.from_numpy((rng.rand(5, 37) < 0.4).astype(np.int32))
    mask[0] = 1
    mask[-1] = 0
    m = mask.numpy()
    want = sum(int(np.sum(m[i][:, None] == m[i][None, :])) for i in range(m.shape[0]))
    assert sweep.in_segment_pairs(mask) == want


def test_bf16_operations_are_twice_the_functions():
    mask = torch.tensor([[1] * 10 + [0] * 6, [1] * 16], dtype=torch.int32)
    pairs = 10 ** 2 + 6 ** 2 + 16 ** 2
    assert sweep.in_segment_pairs(mask) == pairs
    assert sweep.bf16_operations(mask, 12, 64) == 8.0 * 12 * 64 * pairs
    q = torch.zeros(2, 16, 12, 64, dtype=torch.bfloat16)
    ms, by = sweep.bound_ms(q, mask)
    bytes_ms = (4 * q.numel() * 2 + mask.numel() * 4) / sweep.HBM_BYTES_PER_S * 1e3
    ops_ms = 4.0 * 12 * 64 * pairs / sweep.PEAK_FLOPS[torch.bfloat16] * 1e3
    assert ms == max(bytes_ms, ops_ms) and by == ("operations" if ops_ms > bytes_ms else "bytes")
    with_lse, _ = sweep.bound_ms(q, mask, lse=True)
    assert with_lse == pytest.approx(bytes_ms + 2 * 12 * 16 * 4 / sweep.HBM_BYTES_PER_S * 1e3)


def test_bf16_ulps_steps_between_neighbours():
    x = torch.tensor([1.0, -2.0, 0.0, 3.5e-5, 65280.0], dtype=torch.bfloat16)
    bits = x.view(torch.int16)
    up = (bits + 1).view(torch.bfloat16)  # the next bf16 away from zero
    assert sweep.bf16_ulps(x, x) == 0
    assert sweep.bf16_ulps(x, up) == 1
    assert sweep.bf16_ulps(up, x) == 1
    pos, neg = torch.tensor([1], dtype=torch.int16), torch.tensor([-32767], dtype=torch.int16)
    # the smallest subnormals of either sign are two steps apart, +0 and -0 none
    assert sweep.bf16_ulps(pos.view(torch.bfloat16), neg.view(torch.bfloat16)) == 2
    zeros = torch.tensor([0.0], dtype=torch.bfloat16)
    assert sweep.bf16_ulps(zeros, -zeros) == 0
    assert sweep.bf16_ulps(x[:0], x[:0]) == 0
    # near zero, opposite signs are far apart in steps; a floor leaves them out
    near = torch.tensor([1e-6, 0.5], dtype=torch.bfloat16)
    flipped = torch.tensor([-1e-6, 0.5], dtype=torch.bfloat16)
    assert sweep.bf16_ulps(near, flipped) > 10000
    assert sweep.bf16_ulps(near, flipped, min_abs=1e-4) == 0
    assert sweep.bf16_ulps(near, near.flip(0) * 0, min_abs=1e-4) > 0
