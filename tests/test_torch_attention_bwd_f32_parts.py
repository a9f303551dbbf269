"""The arithmetic of kernel 1b's f32 backward (``csrc/flash_attention_bwd.cu``)
emulated on the CPU, against the JAX package's naive attention.

On the card the f32 backward runs on the tensor cores: q, k, v and dO are
split exactly into three bf16 parts each (the parts of
``ops/fused_search.bf16_query_parts``); S = Q K^T and dP = dO V^T are each
the sum of the six products a_i b_j with i + j <= 4 (S in the forward's
products, so the scores its lse was taken over); P = exp(S / sqrt(D) - lse)
from the forward's lse; D = rowsum(dO * O) from the forward's out;
dS = P (dP - D) in f32; and dV = P^T dO, dK = dS^T Q / sqrt(D) and
dQ = dS K / sqrt(D) are each the six products of P's or dS's parts and the
other operand's. The emulation here is a test helper only (no code of the
port calls it): the same parts and products, each product set summed in f64
and rounded to f32 where the kernel rounds, the forward's lse and out as the
forward's emulation (``test_torch_attention_f32_parts``) makes them. It is
held within 1e-5 absolute of ``jax.grad`` of
``convdr_tpu.models.attention.naive_attention`` (f32), with the upstream
gradient zero at pad queries as in ``test_torch_attention_grad.py`` (pooling
never reads them; there the two padding rules agree): the six-part products
drop only terms below 2^-20 of each product. Also the f32 backward's bound of
``convdr_torch/scripts/attention_bwd_bench.py``: the six-part operations
(60HD a pair in segment) at the bf16 peak, beside the CUDA cores' 10HD at
the f32 peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.models.attention import flash_attention_bwd_plain, flash_attention_plain
from convdr_torch.ops.fused_search import bf16_query_parts
from convdr_torch.scripts import attention_bwd_bench as bench
from convdr_torch.scripts.score_sweep import HBM_BYTES_PER_S, PEAK_FLOPS
from convdr_tpu.models.attention import naive_attention
from test_torch_attention_f32_parts import parts as np_parts
from test_torch_attention_f32_parts import six_part as np_six_part
from test_torch_attention_grad import SHAPES, _problem

# (i, j) of the products kept, 1-based parts, in the order (A part, B part)
# of the forward's S and P V and of the backward's dQ blocks and gradients
KEPT = ((1, 1), (2, 1), (1, 2), (3, 1), (2, 2), (1, 3))


def parts(x):
    """The three bf16 parts of an f32 tensor, as f64 [3, *x.shape]."""
    flat = x.to(torch.float32).reshape(-1, x.shape[-1]).contiguous()
    return bf16_query_parts(flat).double().reshape(3, *x.shape)


def six_part(a_parts, b_parts, spec, order=KEPT):
    """(1,1) and the five small products of einsum(spec, a_i, b_j), each set
    summed in f64, added and rounded to f32: the kernel's two sums."""
    big = torch.einsum(spec, a_parts[0], b_parts[0])
    small = sum(torch.einsum(spec, a_parts[i - 1], b_parts[j - 1]) for i, j in order[1:])
    return (big + small).float()


def forward(q, k, v, mask):
    """The f32 forward's S, lse and out (its emulation's arithmetic): the
    six-part S rounded to f32; lse the f64 log-sum-exp of S / sqrt(D) over
    the row's segment, rounded to f32; out the six-part P V over the f64 sum
    of p, rounded to f32."""
    d = q.shape[-1]
    s = six_part(parts(q), parts(k), "bqhd,bkhd->bhqk")
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    z = torch.where(allowed, s.double() / d ** 0.5, torch.tensor(-np.inf, dtype=torch.float64))
    lse = torch.logsumexp(z, -1)
    p = torch.exp(z - z.amax(-1, keepdim=True)).float()
    o = six_part(parts(p), parts(v), "bhqk,bkhd->bqhd").double()
    o = (o / p.double().sum(-1).permute(0, 2, 1)[..., None]).float()
    return s, lse.float(), o


def emulate_bwd(q, k, v, do, mask):
    """dQ, dK, dV of the f32 kernel's arithmetic on [B, T, H, D] f32 tensors
    and a [B, T] 0/1 mask (a query sees the keys of its own segment)."""
    d = q.shape[-1]
    scale = 1.0 / d ** 0.5
    s, lse, o = forward(q, k, v, mask)
    allowed = (mask[:, None, :, None] == mask[:, None, None, :])
    p = torch.where(allowed, torch.exp(s.double() * scale - lse.double()[..., None]),
                    torch.zeros((), dtype=torch.float64)).float()
    delta = (do.double() * o.double()).sum(-1).float().permute(0, 2, 1)  # [B, H, T]
    dp = six_part(parts(do), parts(v), "bqhd,bkhd->bhqk")
    ds = p * (dp - delta[..., None])  # f32, as the kernel forms it
    pq, pk, pdo, pds = parts(q), parts(k), parts(do), parts(ds)
    dv = six_part(parts(p), pdo, "bhqk,bqhd->bkhd")
    dk = six_part(pds, pq, "bhqk,bqhd->bkhd") * scale
    dq = six_part(pds, pk, "bhqk,bkhd->bqhd") * scale
    return dq, dk, dv


def jax_grads(q, k, v, do, mask):
    """jax.grad of the JAX package's naive attention (f32) at upstream
    gradient do."""
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)

    def f(q_, k_, v_):
        out = naive_attention(q_, k_, v_, jnp.asarray(bias), jnp.float32)
        return jnp.sum(out * jnp.asarray(do))

    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in grads]


def check(q, k, v, do, mask):
    do = (do * mask[:, :, None, None]).astype(np.float32)  # pad queries never reach the loss
    got = emulate_bwd(*(torch.from_numpy(x) for x in (q, k, v, do, mask)))
    want = jax_grads(q, k, v, do, mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,t,h,d,lengths", SHAPES)
def test_six_part_backward_matches_jax_grad(b, t, h, d, lengths):
    check(*_problem(11, b, t, h, d, lengths))


@pytest.mark.parametrize("kind", ["right", "random"])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_six_part_backward_on_near_parallel_rows(d, kind):
    """Near-parallel positive rows (1 + 0.01 N(0, 1)): every score one-signed
    and the gradients small beside the terms they sum."""
    q, k, v, do, mask = _problem(d, 2, 200, 2, d, [200, 77])
    if kind == "random":
        rng = np.random.RandomState(d)
        mask = (rng.rand(2, 200) < 0.5).astype(np.int32)
        mask[:, 0] = 1
    q, k, v = (np.float32(1.0) + np.float32(0.01) * x for x in (q, k, v))
    check(q, k, v, do, mask)


@pytest.mark.parametrize("b,t,h,d,lengths", [(2, 70, 3, 64, [70, 33]), (3, 40, 2, 16, [40, 5, 0])])
def test_emulated_s_equals_the_forward_emulation_s(b, t, h, d, lengths):
    """The backward's S^T = K Q^T (K as A, in the dK/dV blocks' order of
    (key part, query part): (1,1), (1,2), (2,1), (1,3), (2,2), (3,1)) and its
    S = Q K^T (dQ blocks) equal the forward emulation's S bit for bit: the
    same six products of the same parts."""
    q, k, _v, _do, _mask = (torch.from_numpy(x) for x in _problem(3, b, t, h, d, lengths))
    want = np_six_part(np_parts(q.numpy()), np_parts(k.numpy()), "bqhd,bkhd->bhqk").astype(
        np.float32)
    key_first = tuple((j, i) for i, j in KEPT)
    s_t = six_part(parts(k), parts(q), "bkhd,bqhd->bhkq", order=key_first)
    s = six_part(parts(q), parts(k), "bqhd,bkhd->bhqk")
    assert key_first == ((1, 1), (1, 2), (2, 1), (1, 3), (2, 2), (3, 1))
    assert np.array_equal(s_t.transpose(-1, -2).numpy(), want)
    assert np.array_equal(s.numpy(), want)


@pytest.mark.parametrize("b,t,lens", [(2, 8, [5, 8]), (4, 256, [256, 100, 31, 0])])
def test_f32_bwd_bound_is_the_six_part_operations_at_the_bf16_peak(b, t, lens):
    """bound_ms of an f32 backward: the larger of the bytes (q, k, v, o, dO
    read, dQ, dK, dV written, the f32 lse and the mask once each) and the
    function's five products in six parts, 60HD operations a pair in
    segment, at the bf16 peak: 0.41 of its 10HD on the CUDA cores at the
    f32 peak (``cuda_core_bound_ms``). The design's seven products (S and
    dP recomputed in the dQ blocks) are 84HD a pair. bf16: 10HD at the bf16
    peak."""
    mask = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None]).int()
    q = torch.zeros(b, t, 12, 64)
    pairs = float(sum(n * n + (t - n) * (t - n) for n in lens))
    assert bench.parts_operations(mask, 12, 64) == 60.0 * 12 * 64 * pairs
    assert bench.design_operations(mask, 12, 64) == 84.0 * 12 * 64 * pairs
    ops_ms = 60.0 * 12 * 64 * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
    nbytes = 8 * q.numel() * 4 + b * 12 * t * 4 + mask.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms, by = bench.bound_ms(q, mask)
    assert ms == pytest.approx(max(ops_ms, bytes_ms))
    assert by == ("operations" if ops_ms > bytes_ms else "bytes")
    fma_ms = bench.cuda_core_bound_ms(q, mask)
    assert fma_ms == pytest.approx(10.0 * 12 * 64 * pairs / PEAK_FLOPS[torch.float32] * 1e3)
    assert 0.40 < ops_ms / fma_ms < 0.41
    ms16, _by16 = bench.bound_ms(q.to(torch.bfloat16), mask)
    ops16 = 10.0 * 12 * 64 * pairs / PEAK_FLOPS[torch.bfloat16] * 1e3
    assert ms16 == pytest.approx(max(ops16, (nbytes - 4 * q.numel() * 4) / HBM_BYTES_PER_S * 1e3))


def _near_parallel_problem(b, t, h, d, seed):
    """f64 near-parallel positive q, k, v (1 + 0.01 N(0, 1)), N(0, 1) dO and
    a right-padded mask whose last row is all pad."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(1.0 + 0.01 * rng.standard_normal((b, t, h, d))) for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((b, t, h, d)))
    lens = rng.integers(1, t + 1, b)
    lens[-1] = 0
    mask = torch.from_numpy((np.arange(t)[None, :] < lens[:, None]).astype(np.int32))
    return q, k, v, do, mask


@pytest.mark.parametrize("b,t,h,d", [(2, 40, 2, 16), (3, 77, 2, 64)])
def test_bwd_given_delta_with_the_exact_d_is_the_f64_plain_backward(b, t, h, d):
    """The near-parallel card test's second yardstick
    (``attention_bwd_bench.bwd_given_delta``): given D = rowsum(dO O) of
    the exact O, the f64 backward equals the f64 plain backward (D = sum P
    dP) to f64 roundings: within 1e-12 of the sum of the magnitudes of each
    gradient's terms (``term_magnitudes``), element by element."""
    q, k, v, do, mask = _near_parallel_problem(b, t, h, d, seed=b * t)
    out = flash_attention_plain(q, k, v, mask)
    delta = (do * out).sum(-1).transpose(1, 2)
    got = bench.bwd_given_delta(q, k, v, do, mask, delta)
    want = flash_attention_bwd_plain(q, k, v, None, do, mask)
    for g, w, m in zip(got, want, bench.term_magnitudes(q, k, v, do, mask)):
        assert g.dtype == torch.float64
        assert bool(((g - w).abs() <= 1e-12 * m).all())


@pytest.mark.parametrize("b,t,h,d", [(2, 40, 2, 16), (3, 77, 2, 64)])
def test_term_magnitudes_bound_each_gradient(b, t, h, d):
    """The near-parallel card test's first yardstick
    (``attention_bwd_bench.term_magnitudes``): each gradient's sum of the
    magnitudes of its terms is at least the gradient's magnitude, element
    by element, and dQ's and dK's are far larger on near-parallel rows,
    where the terms cancel."""
    q, k, v, do, mask = _near_parallel_problem(b, t, h, d, seed=b * t + 1)
    grads = flash_attention_bwd_plain(q, k, v, None, do, mask)
    bounds = bench.term_magnitudes(q, k, v, do, mask)
    for g, m in zip(grads, bounds):
        assert bool((g.abs() <= m).all())
    for g, m in zip(grads[:2], bounds[:2]):
        assert g.abs().max().item() < 0.1 * m.max().item()
