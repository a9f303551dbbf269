"""The arithmetic of kernel 1's f32 forward (``csrc/flash_attention.cu``)
emulated on the CPU, against the JAX package's naive attention.

On the card the f32 forward runs on the tensor cores: q, k and v are split
exactly into three bf16 parts each (the parts of
``ops/fused_search.bf16_query_parts``), S = Q K^T is the sum of the six
products q_i k_j with i + j <= 4, and O = P V the sum of the six products
p_i v_j of the probabilities' parts and v's. The emulation here is a test
helper only (no code of the port calls it): the same parts and products,
each sum taken in f64 and rounded to f32 once, the softmax in between. It
is held within 1e-5 absolute of ``convdr_tpu.models.attention.
naive_attention`` (f32) at valid query positions (the JAX naive path masks
pad keys for every query, so pad queries differ by design): the six-part
products drop only terms below 2^-20 of each product, far under that
tolerance. The dropped products (2,3), (3,2) and (3,3) are checked term by
term against that bound. Also the f32 bound of
``convdr_torch/scripts/attention_sweep.py``: the six-part operations (24HD
a pair in segment) at the bf16 peak, beside the CUDA cores' 4HD at the f32
peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.ops.fused_search import bf16_query_parts
from convdr_torch.scripts import attention_sweep as sweep
from convdr_tpu.models.attention import naive_attention

# (i, j) of the products kept, 1-based parts, in the kernel's order
KEPT = ((1, 1), (1, 2), (2, 1), (1, 3), (2, 2), (3, 1))
DROPPED = ((2, 3), (3, 2), (3, 3))


def parts(x):
    """The three bf16 parts of an f32 array, as f64 [3, *x.shape]."""
    flat = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32).reshape(-1, x.shape[-1]))
    return bf16_query_parts(flat).double().numpy().reshape(3, *x.shape)


def six_part(a_parts, b_parts, spec):
    """sum over the kept (i, j) of einsum(spec, a_i, b_j), in f64."""
    return sum(np.einsum(spec, a_parts[i - 1], b_parts[j - 1]) for i, j in KEPT)


def emulate(q, k, v, mask):
    """The f32 kernel's arithmetic on [B, T, H, D] f32 q, k, v and a [B, T]
    0/1 mask (a query sees the keys of its own segment): the six-part S in
    f64 rounded to f32, p = exp(S / sqrt(D) - max) in f64 rounded to f32,
    the six-part P V of p's parts and v's in f64, over the f64 sum of p,
    rounded to f32 once."""
    d = q.shape[-1]
    s = six_part(parts(q), parts(k), "bqhd,bkhd->bhqk").astype(np.float32)
    allowed = mask[:, None, :, None] == mask[:, None, None, :]
    z = np.where(allowed, s.astype(np.float64) / np.sqrt(d), -np.inf)
    p = np.exp(z - z.max(-1, keepdims=True)).astype(np.float32)
    o = six_part(parts(p), parts(v), "bhqk,bkhd->bqhd")
    return (o / p.astype(np.float64).sum(-1).transpose(0, 2, 1)[..., None]).astype(np.float32)


def problem(seed, b, t, h, d, kind):
    """Seeded N(0, 1) q, k, v and a mask whose rows hold a random number of
    valid tokens first ("right"), last ("left"), in a run between pads
    ("middle"), or ("random") each token valid with probability 1/2; every
    row keeps at least one valid token."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, t + 1, b)
    pos = np.arange(t)[None, :]
    if kind == "right":
        valid = pos < lens[:, None]
    elif kind == "left":
        valid = pos >= t - lens[:, None]
    elif kind == "middle":
        start = rng.integers(0, t - lens + 1)
        valid = (pos >= start[:, None]) & (pos < (start + lens)[:, None])
    else:
        valid = rng.random((b, t)) < 0.5
        valid[np.arange(b), rng.integers(0, t, b)] = True
    return q, k, v, valid.astype(np.int32)


def jax_naive(q, k, v, mask):
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    return np.asarray(naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(bias), jnp.float32))


@pytest.mark.parametrize("kind", ["right", "left", "middle", "random"])
@pytest.mark.parametrize("b,t,d", [(2, 1, 64), (3, 65, 16), (2, 130, 32), (2, 300, 64),
                                   (1, 257, 16)])
def test_six_part_emulation_matches_jax_naive(b, t, d, kind):
    q, k, v, mask = problem(t * d + len(kind), b, t, 2, d, kind)
    got = emulate(q, k, v, mask)
    want = jax_naive(q, k, v, mask)
    valid = mask.astype(bool)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["right", "random"])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_six_part_emulation_on_near_parallel_rows(d, kind):
    """Near-parallel positive rows (1 + 0.01 N(0, 1)): every score and every
    P V term of one sign, the sums the tensor cores find hardest."""
    q, k, v, mask = problem(d, 2, 200, 2, d, kind)
    q, k, v = (np.float32(1.0) + np.float32(0.01) * x for x in (q, k, v))
    got = emulate(q, k, v, mask)
    want = jax_naive(q, k, v, mask)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)


def test_parts_are_exact():
    """q1 + q2 + q3 == q bit for bit for f32 values across magnitudes,
    including P's range (0, 1] down to 2^-100."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 96)) * 2.0 ** rng.integers(-100, 60, (64, 96))).astype(
        np.float32)
    x[0, :3] = (0.0, 1.0, -1.0)
    p = parts(x)
    assert np.array_equal((p[0] + p[1] + p[2]).astype(np.float32), x)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_dropped_products_are_below_2_to_the_minus_20_of_their_term(scale):
    """For every pair of elements a, b (q and k along d, p and v along the
    keys), each dropped product a_i b_j, (i, j) in (2,3), (3,2), (3,3), is
    at most 2^-20 |a b|: a part past the first is under 2^-7 of what it
    splits, so a_2 b_3 and a_3 b_2 are under 2^-21 |a b| and a_3 b_3 under
    2^-28."""
    rng = np.random.default_rng(int(scale * 1000) % 97)
    a = (rng.standard_normal(4096) * scale).astype(np.float32)
    b = rng.random(4096).astype(np.float32)  # P's range
    pa, pb = parts(a), parts(b)
    term = np.abs(a.astype(np.float64) * b.astype(np.float64))
    for i, j in DROPPED:
        assert np.all(np.abs(pa[i - 1] * pb[j - 1]) <= 2.0 ** -20 * term), (i, j)
    kept = sum(pa[i - 1] * pb[j - 1] for i, j in KEPT)
    assert np.all(np.abs(kept - a.astype(np.float64) * b) <= 3 * 2.0 ** -20 * term)


@pytest.mark.parametrize("b,t,lens", [(2, 8, [5, 8]), (3, 512, [512, 100, 0])])
def test_f32_bound_is_the_six_part_operations_at_the_bf16_peak(b, t, lens):
    """bound_ms of an f32 problem: the larger of the bytes (q, k, v, out and
    the mask once each) and the six-part products' 24HD operations a pair
    in segment at the bf16 peak, 0.41 of the function's 4HD on the CUDA
    cores at the f32 peak (``cuda_core_bound_ms``)."""
    mask = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).int()
    q = torch.zeros(b, t, 12, 64)
    pairs = float(sum(n * n + (t - n) * (t - n) for n in lens))
    assert sweep.in_segment_pairs(mask) == pairs
    assert sweep.f32_parts_operations(mask, 12, 64) == 24.0 * 12 * 64 * pairs
    ops_ms = 24.0 * 12 * 64 * pairs / sweep.PEAK_FLOPS[torch.bfloat16] * 1e3
    bytes_ms = (4 * q.numel() * 4 + mask.numel() * 4) / sweep.HBM_BYTES_PER_S * 1e3
    ms, by = sweep.bound_ms(q, mask)
    assert ms == pytest.approx(max(ops_ms, bytes_ms))
    assert by == ("operations" if ops_ms > bytes_ms else "bytes")
    fma_ms = sweep.cuda_core_bound_ms(q, mask)
    assert fma_ms == pytest.approx(4.0 * 12 * 64 * pairs / sweep.PEAK_FLOPS[torch.float32] * 1e3)
    assert ops_ms / fma_ms == pytest.approx(
        6 * sweep.PEAK_FLOPS[torch.float32] / sweep.PEAK_FLOPS[torch.bfloat16])
    assert 0.40 < ops_ms / fma_ms < 0.41
