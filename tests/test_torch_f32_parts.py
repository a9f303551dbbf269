"""The six-part bf16 product of the port's f32 search (CPU).

On the card, kernels 2, 3 and 4 score f32 queries against f32 passages as
six bf16 tensor-core products: each operand splits exactly into three bf16
parts (``bf16_query_parts``' arithmetic: the queries by the wrapper above
Q=16, the passages in the kernel from the stored rows), and of the nine
part products q_i p_j the six with i + j <= 4 are summed, the counterpart
of the JAX kernel's ``Precision.HIGHEST`` on f32 x f32 (six bf16 MXU
passes). Here: the passage split is exact (in f64 the parts sum to the
value) over seeded normals and edge values (0, -0, +-1e-30, +-3e38, f32's
largest values); in f64 the six products of every term lie within 2^-20 of
|q_k p_k| of the term, and so their sums within 2^-20 sum |q_k p_k| of the
product; the kernel's operands are the D-padded queries or their parts;
and the top-100 sets of the search on six-part scores (the port's
group-max selection) equal the JAX package's ``flat_ip_topk`` at HIGHEST on
the same numpy-seeded inputs, up to near-ties within 1e-5 |q| max|p|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.ops import exact_search as tes
from convdr_torch.ops import fused_search as tfs
from convdr_tpu.ops import exact_search as jes

F32_MAX = float(np.finfo(np.float32).max)
EDGES = [0.0, -0.0, 1e-30, -1e-30, 3e38, -3e38, F32_MAX, -F32_MAX, 2.0 ** -110, 1.0, -1.0]
# (query part, passage part) of the six products, in the kernels' order
SIX = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def seeded_rows(seed, scale_bits, n=40, d=96):
    """N(0, 1) f32 rows, each element scaled by 2^u, u uniform in
    [-scale_bits, scale_bits]."""
    rng = np.random.RandomState(seed)
    scale = np.exp2(rng.randint(-scale_bits, scale_bits + 1, size=(n, d))).astype(np.float32)
    return (rng.randn(n, d).astype(np.float32) * scale).astype(np.float32)


def parts64(x):
    """The three bf16 parts [3, *x.shape] of f32 ``x``, in f64."""
    parts = tfs.bf16_query_parts(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *x.shape)
    return parts.double().numpy()


def six_part_scores(q, p):
    """The six-part scores [Q, N] of f32 q [Q, D] and p [N, D]: the sum of
    the six part products in f64, rounded to f32 once."""
    qp, pp = parts64(q), parts64(p)
    return sum(qp[i] @ pp[j].T for i, j in SIX).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "wide", "very_wide", "edges", "near_parallel"])
def test_passage_parts_sum_to_the_value(case):
    """In f64 the three parts of every passage value sum to it exactly, are
    finite, and each is at most 2^-7 of the one before it."""
    if case == "edges":
        p = np.array([EDGES], np.float32)
    elif case == "near_parallel":
        p = (1 + 0.01 * np.random.RandomState(3).randn(40, 96)).astype(np.float32)
    else:
        p = seeded_rows({"normal": 0, "wide": 1, "very_wide": 2}[case],
                        {"normal": 0, "wide": 40, "very_wide": 100}[case])
    parts = parts64(p)
    np.testing.assert_array_equal(parts.sum(0), p.astype(np.float64))
    assert np.isfinite(parts).all()
    for a, b in ((0, 1), (1, 2)):
        assert (np.abs(parts[b]) <= np.abs(parts[a]) * 2.0 ** -7).all()


@pytest.mark.parametrize("d", [8, 100, 768])
@pytest.mark.parametrize("scale_bits", [0, 30])
def test_six_part_product_within_2_pow_minus_20(d, scale_bits):
    """Term by term, the six part products of q_k p_k sum (exactly, in
    f64) to within 2^-20 |q_k p_k| of it, and with the three dropped ones
    to it exactly; the six-part dot products lie within 2^-20 sum |q_k p_k|
    of the f64 product, plus f64 rounding."""
    q = seeded_rows(3 + d, scale_bits, n=5, d=d)
    p = seeded_rows(4 + d, scale_bits, n=30, d=d)
    qp, pp = parts64(q), parts64(p)
    exact = q.astype(np.float64)[:, None, :] * p.astype(np.float64)[None]  # [Q, N, D]
    six = sum(qp[i][:, None, :] * pp[j][None] for i, j in SIX)
    dropped = sum(qp[i][:, None, :] * pp[j][None] for i, j in ((1, 2), (2, 1), (2, 2)))
    np.testing.assert_array_equal(six + dropped, exact)
    assert (np.abs(six - exact) <= 2.0 ** -20 * np.abs(exact)).all()
    mag = np.abs(exact).sum(-1)
    err = np.abs(six.sum(-1) - exact.sum(-1))
    assert (err <= 2.0 ** -20 * mag + 4 * d * 2.0 ** -53 * mag).all()


@pytest.mark.parametrize("qn", [3, 16, 17, 65])
@pytest.mark.parametrize("d", [8, 100, 768, 1040])
def test_kernel_operands_of_f32_passages(d, qn):
    """What the f32 kernels take: up to Q=16 the f32 queries, D padded with
    zeros to 4 (16 bytes), which the kernel splits itself; above it the
    [3, Q, D8] bf16 parts of the queries padded to 8 (D8: the parts' rows
    in 16-byte chunks), summing to them; contiguous and 16-byte aligned.
    The passages as stored when D needs no padding."""
    q = torch.from_numpy(seeded_rows(5, 20, n=qn, d=d))
    p = torch.randn(128, d, generator=torch.Generator().manual_seed(0))
    qk, pk = tfs.kernel_operands(q, p)
    d4, d8 = -(-d // 4) * 4, -(-d // 8) * 8
    if qn <= tfs.F32_SPLIT_Q_MAX:
        assert qk.shape == (qn, d4) and qk.dtype == torch.float32
        assert torch.equal(qk, torch.nn.functional.pad(q, (0, d4 - d)))
    else:
        assert qk.shape == (3, qn, d8) and qk.dtype == torch.bfloat16
        assert torch.equal(qk.double().sum(0), torch.nn.functional.pad(q, (0, d8 - d)).double())
    assert qk.is_contiguous() and qk.data_ptr() % 16 == 0 and pk.shape == (128, d4)
    if d4 == d:
        assert pk.data_ptr() == p.data_ptr()


def assert_sets_near(got_i, want_i, exact, qnorm, pmax, k):
    """Each row's top-k index sets equal, or differing only in rows whose
    exact (f64) scores lie within 1e-5 |q| max|p| of the k-th exact score
    of the reference set."""
    for r in range(len(got_i)):
        a, b = set(got_i[r].tolist()), set(want_i[r].tolist())
        if a == b:
            continue
        kth = np.sort(exact[r, list(b)])[0]
        tol = 1e-5 * qnorm[r] * pmax
        assert all(abs(exact[r, i] - kth) <= tol for i in a ^ b), r


@pytest.mark.parametrize("qn,n,d,kind", [(4, 700, 64, "normal"), (65, 1000, 768, "normal"),
                                         (1, 3000, 100, "normal"), (8, 1024, 768, "near_parallel")])
def test_six_part_topk_same_set_as_jax(qn, n, d, kind):
    """The port's group-max selection (``select_from_groupmax``, G=32) on
    the six-part scores of f32 passages: the top-100 sets of the JAX
    package's ``flat_ip_topk`` at HIGHEST on the same numpy-seeded inputs
    and of the port's f32 ``flat_ip_topk`` on the CPU, up to near-ties."""
    rng = np.random.RandomState(qn + n + d)
    if kind == "near_parallel":
        q = (1 + 0.01 * rng.randn(qn, d)).astype(np.float32)
        p = (1 + 0.01 * rng.randn(n, d)).astype(np.float32)
    else:
        q, p = rng.randn(qn, d).astype(np.float32), rng.randn(n, d).astype(np.float32)
    k, group = 100, 32
    pad = (-n) % group
    s6 = np.pad(six_part_scores(q, p), ((0, 0), (0, pad)))
    s3 = torch.from_numpy(s6).view(qn, -1, group)
    _, six_i = tes.select_from_groupmax(s3, s3.amax(-1), k, group, n if pad else None)
    _, jax_i = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), k, precision="highest")
    _, cpu_i = tes.flat_ip_topk(torch.from_numpy(q), torch.from_numpy(p), k)
    exact = q.astype(np.float64) @ p.astype(np.float64).T
    qnorm, pmax = np.linalg.norm(q, axis=1), np.linalg.norm(p, axis=1).max()
    assert six_i.shape == (qn, k) and (six_i.numpy() < n).all()
    assert_sets_near(six_i.numpy(), np.asarray(jax_i), exact, qnorm, pmax, k)
    assert_sets_near(six_i.numpy(), cpu_i.numpy(), exact, qnorm, pmax, k)
