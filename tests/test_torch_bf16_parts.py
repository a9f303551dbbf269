"""The three-part bf16 query split of the port's bf16 search (CPU).

On the card, kernels 2, 3 and 4 score f32 queries against bf16 passages as
three bf16 tensor-core products: each query splits exactly into three bf16
parts (``bf16_query_parts``), so every part times a bf16 passage is exact
and the sum of the three products is the product of the query itself, the
counterpart of the JAX kernel's ``Precision.HIGHEST`` on f32 x bf16. Here:
the split is exact (in f64 the parts sum to the query) over seeded normals
at many scales and edge values (0, -0, +-1e-30, +-3e38, f32's largest
values, and values halfway between two bf16s, where rounding and cutting
part ways); the three part products equal the query's product element for
element in f64, and their sums agree within f64 rounding; the kernel's
operands are the D-padded queries or their parts; and the port's bf16-storage
searches on the CPU give the JAX package's top-k sets on the same seeded
inputs.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.ops import exact_search as tes
from convdr_torch.ops import fused_search as tfs
from convdr_torch.ops.streaming_search import streaming_flat_ip_topk
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.ops import exact_search as jes
from convdr_tpu.ops.pallas_search import pallas_flat_ip_topk
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxSearcher

CPU = torch.device("cpu")
F32_MAX = float(np.finfo(np.float32).max)
# f32 values halfway between two neighbouring bf16s (and next to it): bf16
# rounding goes to even, the split cuts; 1 + 2^-8 + 2^-23 needs all three parts
TIES = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 2.0 ** 100 * (1 + 2.0 ** -8),
        1 + 2.0 ** -8 + 2.0 ** -23, 1 - 2.0 ** -24, 3 * 2.0 ** -9]
EDGES = [0.0, -0.0, 1e-30, -1e-30, 3e38, -3e38, F32_MAX, -F32_MAX, 2.0 ** -110, 1.0, -1.0]


def seeded_queries(seed, scale_bits, q=7, d=96):
    """N(0, 1) f32 queries, each element scaled by 2^u, u uniform in
    [-scale_bits, scale_bits]."""
    rng = np.random.RandomState(seed)
    scale = np.exp2(rng.randint(-scale_bits, scale_bits + 1, size=(q, d))).astype(np.float32)
    return (rng.randn(q, d).astype(np.float32) * scale).astype(np.float32)


def split(q):
    parts = tfs.bf16_query_parts(torch.from_numpy(np.ascontiguousarray(q, np.float32)))
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *q.shape)
    return parts


@pytest.mark.parametrize("case", ["normal", "wide", "very_wide", "edges", "ties"])
def test_query_parts_sum_to_the_query(case):
    """In f64 the three parts sum to the query exactly, each part is a bf16
    value (the tensor's dtype), and each part is at most 2^-7 of the one
    before it (the split cuts 8 bits of significand a part)."""
    if case == "edges":
        q = np.array([EDGES], np.float32)
    elif case == "ties":
        q = np.array([TIES], np.float32)
    else:
        q = seeded_queries({"normal": 0, "wide": 1, "very_wide": 2}[case],
                           {"normal": 0, "wide": 40, "very_wide": 100}[case])
    parts = split(q).double().numpy()
    np.testing.assert_array_equal(parts.sum(0), q.astype(np.float64))
    assert np.isfinite(parts).all()
    for a, b in ((0, 1), (1, 2)):
        assert (np.abs(parts[b]) <= np.abs(parts[a]) * 2.0 ** -7).all()


def test_query_parts_of_ties_differ_from_rounding():
    """At a bf16 tie the first part is the cut value, not the rounded one:
    1 + 2^-8 splits into 1 and 2^-8 (round-to-nearest-even would give 1
    too, 1 + 3 2^-8 would round up to 1 + 2^-6)."""
    parts = split(np.array([[1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8]], np.float32)).double().numpy()
    np.testing.assert_array_equal(parts[:, 0, 0], [1.0, 2.0 ** -8, 0.0])
    np.testing.assert_array_equal(parts[:, 0, 1], [1 + 2.0 ** -7, 2.0 ** -8, 0.0])


@pytest.mark.parametrize("d", [8, 100, 768])
@pytest.mark.parametrize("scale_bits", [0, 30])
def test_three_part_product_equals_the_f64_product(d, scale_bits):
    """q_1 p + q_2 p + q_3 p equals q p in f64 for every term (each part
    times a bf16 value is exact in f64, and so is their sum); the three
    parts' dot products sum to the query's within f64 rounding."""
    q = seeded_queries(3 + d, scale_bits, q=5, d=d)
    p = np.random.RandomState(4).randn(40, d).astype(ml_dtypes.bfloat16).astype(np.float64)
    parts = split(q).double().numpy()
    terms = parts[:, :, None, :] * p[None, None, :, :]  # [3, Q, N, D]
    np.testing.assert_array_equal(terms.sum(0), q.astype(np.float64)[:, None, :] * p[None])
    exact = q.astype(np.float64) @ p.T
    three = sum(parts[i] @ p.T for i in range(3))
    bound = 4 * d * 2.0 ** -53 * (np.abs(q.astype(np.float64)) @ np.abs(p).T)
    assert (np.abs(three - exact) <= bound).all()


@pytest.mark.parametrize("qn", [3, 65])
@pytest.mark.parametrize("d", [8, 100, 768, 1040])
def test_kernel_operands_hold_the_parts_of_the_padded_queries(d, qn):
    """What the bf16 kernels take, D padded with zeros to 8 bf16 (16
    bytes), contiguous and 16-byte aligned: up to Q=64 the f32 queries,
    which the kernel splits itself; above it the [3, Q, D8] parts, summing
    to the padded queries. The passages as stored when D needs no padding."""
    q = torch.from_numpy(seeded_queries(5, 20, q=qn, d=d))
    p = torch.randn(128, d, generator=torch.Generator().manual_seed(0)).bfloat16()
    qk, pk = tfs.kernel_operands(q, p)
    d8 = -(-d // 8) * 8
    padded = torch.nn.functional.pad(q, (0, d8 - d)).double()
    if qn <= tfs.BF16_SMALL_Q_MAX:
        assert qk.shape == (qn, d8) and qk.dtype == torch.float32
        assert torch.equal(qk.double(), padded)
    else:
        assert qk.shape == (3, qn, d8) and qk.dtype == torch.bfloat16
        assert torch.equal(qk.double().sum(0), padded)
    assert qk.is_contiguous() and qk.data_ptr() % 16 == 0 and pk.shape == (128, d8)
    if d8 == d:
        assert pk.data_ptr() == p.data_ptr()


def problem(seed, q=5, n=600, d=64):
    rng = np.random.RandomState(seed)
    return rng.randn(q, d).astype(np.float32), rng.randn(n, d).astype(np.float32)


@pytest.mark.parametrize("qn,n,d,block_rows", [(4, 400, 64, 128), (1, 700, 100, 256),
                                               (17, 1000, 768, 1000), (65, 300, 32, 128)])
def test_bf16_flat_ip_topk_same_set_as_jax(qn, n, d, block_rows):
    """The port's bf16-storage ``flat_ip_topk``, its fused and streaming
    searches on the CPU: the same top-k sets as the JAX package's
    ``flat_ip_topk`` on bf16 passages and its Pallas search (interpret
    mode), and as the numpy oracle on the rounded rows."""
    q, p = problem(qn + n, q=qn, n=n, d=d)
    p_bf16 = torch.from_numpy(p).to(torch.bfloat16)
    k = 20
    _, i = tes.flat_ip_topk(torch.from_numpy(q), p_bf16, k, block_rows=block_rows)
    _, fi = tfs.fused_flat_ip_topk(torch.from_numpy(q), p_bf16, k, group=8)
    _, si = streaming_flat_ip_topk(torch.from_numpy(q), p_bf16, k, group=8)
    _, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p, dtype=jnp.bfloat16), k,
                             block_rows=block_rows)
    rounded = p_bf16.float().numpy()
    pad = (-n) % 64
    _, pi = pallas_flat_ip_topk(jnp.asarray(q), jnp.asarray(np.pad(rounded, ((0, pad), (0, 0)))),
                                k, group=8, tile_rows=64, valid_rows=n, interpret=True)
    _, oi = jes.topk_oracle(q, rounded, k)
    for r in range(qn):
        want = set(oi[r])
        assert set(i.numpy()[r]) == set(fi.numpy()[r]) == set(si.numpy()[r]) == want
        assert set(np.asarray(ji)[r]) == set(np.asarray(pi)[r]) == want


@pytest.mark.parametrize("seed", [21, 22])
def test_bf16_blocked_searcher_same_set_as_jax(tmp_path, seed):
    """``BlockedSearcher`` under bf16 storage over row-robin blocks and
    over arrays: the JAX searcher's top-k sets on the same seeded rows."""
    rng = np.random.RandomState(seed)
    passages = rng.randn(300, 48).astype(np.float32)
    queries = rng.randn(6, 48).astype(np.float32)
    for b in range(3):
        rows = np.arange(b, 300, 3)
        write_embedding_block(str(tmp_path), b, passages[rows], rows.astype(np.int64))
    ours = BlockedSearcher(SearchConfig(passage_block_size=64, storage_dtype="bfloat16"),
                           device=CPU)
    ref = JaxSearcher(JaxSearchConfig(passage_block_size=64, storage_dtype="bfloat16"))
    _, offsets = ours.search_blocks(str(tmp_path), queries, 25)
    _, joffsets = ref.search_blocks(str(tmp_path), queries, 25)
    emb2offset = np.arange(300, dtype=np.int64) + 5
    _, aoff = ours.search_arrays(queries, passages, emb2offset, 25)
    _, jaoff = ref.search_arrays(queries, passages, emb2offset, 25)
    for r in range(6):
        assert set(offsets[r]) == set(joffsets[r])
        assert set(aoff[r]) == set(jaoff[r])
