"""convdr_torch's PQ codec, ADC scan and PQ index against the JAX package's
(CPU).

Mirrors the single-device cases of ``tests/test_pq.py`` and
``tests/test_pq_index.py``; the same seeded inputs go through both packages.
Tolerances, stated per test:

  * the LUT is the JAX package's numpy: bit-identical;
  * encode assigns in f32 in both packages: equal codes, a row may differ
    only where two centroids tie within 1e-5 of its distance;
  * ADC with ``exact=True``: the numpy oracle's top-k sets, scores within
    1e-5 (another summation order); by default both packages round the LUT
    to bf16 and sum in f32, so their top-k ids are equal and their scores
    within 1e-5;
  * packed and unpacked codes give bit-identical results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convdr_torch.ops import pq as tpq
from convdr_torch.ops.exact_search import NEG_INF, topk_oracle
from convdr_torch.ops.pq import PQCodec, pq_adc_oracle, pq_flat_topk
from convdr_torch.ops.quant import Int8Quantizer
from convdr_torch.parallel.dryrun import single_rank
from convdr_torch.parallel.mesh import get_mesh
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex, is_pq_index_dir
from convdr_tpu.ops import pq as jpq
from convdr_tpu.retrieval.pq_index import PQIndex as JaxPQIndex

CPU = torch.device("cpu")


def clustered(rng, n=1200, d=32, n_clusters=24, spread=0.15):
    centers = rng.randn(n_clusters, d).astype(np.float32)
    assign = rng.randint(0, n_clusters, size=n)
    return (centers[assign] + spread * rng.randn(n, d).astype(np.float32)).astype(np.float32)


def correlated(rng, n=2000, d=32):
    z = rng.randn(n, d).astype(np.float32)
    mix = rng.randn(d, d).astype(np.float32)
    scales = np.logspace(0, -1.5, d).astype(np.float32)
    return (z * scales[None, :]) @ mix


def corpus(seed=3, n=800, d=32):
    rng = np.random.Generator(np.random.PCG64(seed))
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_topk_set_equal(s, i, want_s, want_i):
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-5)
    for q in range(i.shape[0]):
        assert set(i[q].tolist()) == set(want_i[q].tolist())


@pytest.fixture(scope="module")
def codec_problem():
    rng = np.random.RandomState(7)
    passages = clustered(rng, n=1500, d=32)
    queries = clustered(rng, n=9, d=32)
    codec = PQCodec.fit(passages, m=8, nbits=4, iters=12, seed=3, device=CPU)
    codes = codec.encode(passages, device=CPU)
    return passages, queries, codec, codes


@pytest.fixture(scope="module")
def built():
    x = corpus()
    index = PQIndex.build(x, m=8, nbits=4, iters=8, seed=1, device=CPU)
    queries = x[:7] + 0.02 * corpus(seed=9, n=7)
    return x, index, queries


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
def test_fit_shapes_and_validation(codec_problem):
    _, _, codec, codes = codec_problem
    assert codec.codebooks.shape == (8, 16, 4)
    assert codec.dim == 32 and codec.ksub == 16 and codec.code_bytes == 8
    assert codes.dtype == np.uint8 and codes.max() < 16
    with pytest.raises(ValueError):
        PQCodec(codec.codebooks, nbits=8)
    with pytest.raises(ValueError):
        PQCodec.fit(np.zeros((100, 30), np.float32), m=7, nbits=4, device=CPU)


def test_split_empty_subspace_equals_jax():
    c = np.random.RandomState(1).randn(3, 4, 2).astype(np.float32)
    counts = np.array([[5, 0, 0, 2], [1, 0, 0, 0], [3, 3, 3, 3]], np.float32)
    got = tpq._split_empty_subspace(c, counts)
    want = jpq._split_empty_subspace(c, counts)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 5


@pytest.mark.parametrize("nbits", [4, 8])
def test_encode_equals_jax_on_the_same_codebooks(codec_problem, nbits):
    passages, _, codec, _ = codec_problem
    if nbits == 8:
        codec = PQCodec(jpq.PQCodec.fit(passages, m=8, nbits=8, iters=4, seed=2).codebooks, 8)
    got = codec.encode(passages, device=CPU)
    want = jpq.PQCodec(codec.codebooks, nbits).encode(passages)
    x = passages.reshape(-1, codec.m, codec.dsub)
    for mi in np.flatnonzero((got != want).any(axis=0)):
        d2 = ((x[:, mi, None, :] - codec.codebooks[None, mi]) ** 2).sum(-1)
        rows = np.flatnonzero(got[:, mi] != want[:, mi])
        np.testing.assert_allclose(d2[rows, got[rows, mi]], d2[rows, want[rows, mi]], rtol=1e-5)
    assert (got == want).mean() > 0.999


def test_encode_matches_numpy_nearest(codec_problem):
    passages, _, codec, codes = codec_problem
    x = passages.reshape(passages.shape[0], codec.m, codec.dsub)
    for mi in range(codec.m):
        d2 = ((x[:, mi, None, :] - codec.codebooks[None, mi]) ** 2).sum(-1)
        want = np.argmin(d2, axis=1)
        got = codes[:, mi].astype(np.int64)
        diff = want != got
        np.testing.assert_allclose(d2[diff, want[diff]], d2[diff, got[diff]], rtol=1e-5)


def test_fit_decode_reconstruction_beats_mean(codec_problem):
    passages, _, codec, codes = codec_problem
    mse = ((codec.decode(codes) - passages) ** 2).mean()
    assert mse < 0.25 * ((passages - passages.mean(0)) ** 2).mean()
    # the JAX fit on the same sample lands at the same quality (within 10%)
    jc = jpq.PQCodec.fit(passages, m=8, nbits=4, iters=12, seed=3)
    jmse = ((jc.decode(jc.encode(passages)) - passages) ** 2).mean()
    assert abs(mse - jmse) <= 0.1 * jmse, (mse, jmse)


def test_lut_and_decode_bit_identical_to_jax(codec_problem):
    _, queries, codec, codes = codec_problem
    jc = jpq.PQCodec(codec.codebooks, codec.nbits)
    np.testing.assert_array_equal(codec.lut(queries), jc.lut(queries))
    np.testing.assert_array_equal(codec.decode(codes), jc.decode(codes))
    s, i = pq_adc_oracle(codec.lut(queries), codes, 5)
    js, ji = jpq.pq_adc_oracle(jc.lut(queries), codes, 5)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(i, ji)


def test_persistence_cross_loads(tmp_path, codec_problem):
    passages, queries, codec, codes = codec_problem
    codec.save(str(tmp_path / "t"))
    jc = jpq.PQCodec.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(jc.codebooks, codec.codebooks)
    jc.save(str(tmp_path / "j"))
    back = PQCodec.load(str(tmp_path / "j"))
    assert back.nbits == codec.nbits
    np.testing.assert_array_equal(back.encode(passages[:64], device=CPU), codes[:64])
    assert PQCodec.load_optional(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        PQCodec.load(str(tmp_path / "nope"))


# ---------------------------------------------------------------------------
# flat ADC scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block_rows", [1 << 18, 256, 100])
def test_flat_topk_matches_oracle(codec_problem, block_rows):
    _, queries, codec, codes = codec_problem
    lut = codec.lut(queries)
    want_s, want_i = pq_adc_oracle(lut, codes, k=10)
    s, i = pq_flat_topk(t(lut), t(codes), 10, codec.ksub, block_rows=block_rows, exact=True)
    assert i.dtype == torch.int64
    assert_topk_set_equal(s.numpy(), i.numpy(), want_s, want_i)


@pytest.mark.parametrize("exact", [False, True])
def test_flat_topk_equals_jax(codec_problem, exact):
    _, queries, codec, codes = codec_problem
    lut = codec.lut(queries)
    s, i = pq_flat_topk(t(lut), t(codes), 20, codec.ksub, exact=exact)
    js, ji = jpq.pq_flat_topk(jnp.asarray(lut), jnp.asarray(codes), 20, codec.ksub, exact=exact)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    if not exact:
        # the default sums the bf16-rounded LUT: the oracle on that LUT
        lut16 = tpq.round_lut(t(lut), False).numpy()
        assert_topk_set_equal(s.numpy(), i.numpy(), *pq_adc_oracle(lut16, codes, 20))


def test_adc_block_scores_is_the_lut_sum(codec_problem):
    _, queries, codec, codes = codec_problem
    lut = codec.lut(queries)
    flat = t(lut.reshape(len(queries), -1))
    got = tpq.adc_block_scores(flat, t(codes[:50]), codec.ksub, "highest").numpy()
    want = sum(lut[:, m, codes[:50, m]] for m in range(codec.m))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rounded = tpq.adc_block_scores(flat, t(codes[:50]), codec.ksub).numpy()
    lut16 = tpq.round_lut(t(lut), False).numpy()
    np.testing.assert_allclose(rounded, sum(lut16[:, m, codes[:50, m]] for m in range(codec.m)),
                               rtol=1e-5, atol=1e-5)


def test_flat_topk_valid_rows_mask(codec_problem):
    _, queries, codec, codes = codec_problem
    lut = codec.lut(queries)
    n = codes.shape[0]
    padded = np.concatenate([codes, codes[:37]])
    s, i = pq_flat_topk(t(lut), t(padded), 8, codec.ksub, valid_rows=n, exact=True)
    assert i.max().item() < n
    assert_topk_set_equal(s.numpy(), i.numpy(), *pq_adc_oracle(lut, codes, k=8))


def test_flat_topk_k_exceeds_corpus(codec_problem):
    _, queries, codec, codes = codec_problem
    lut = codec.lut(queries)
    s, i = pq_flat_topk(t(lut), t(codes[:6]), 9, codec.ksub, exact=True)
    s, i = s.numpy(), i.numpy()
    assert s.shape == (9, 9) and np.all(i[:, 6:] == -1) and np.all(s[:, 6:] == NEG_INF)
    assert_topk_set_equal(s[:, :6], i[:, :6], *pq_adc_oracle(lut, codes[:6], k=6))


def test_pq8_candidate_recall_against_float_search():
    rng = np.random.RandomState(11)
    passages = clustered(rng, n=3000, d=64, n_clusters=40)
    queries = clustered(rng, n=12, d=64, n_clusters=40)
    codec = PQCodec.fit(passages, m=16, nbits=8, iters=10, seed=5, device=CPU)
    codes = codec.encode(passages, device=CPU)
    lut = codec.lut(queries)
    _, want_i = topk_oracle(queries, passages, 10)

    def overlap(k_cand):
        i = pq_flat_topk(t(lut), t(codes), k_cand, codec.ksub)[1].numpy()
        return np.mean([len(set(i[q]) & set(want_i[q])) / 10.0 for q in range(12)])

    assert overlap(10) >= 0.35
    assert overlap(50) >= 0.85


# ---------------------------------------------------------------------------
# OPQ and packed codes
# ---------------------------------------------------------------------------
def test_opq_reduces_reconstruction_error():
    x = correlated(np.random.RandomState(31))
    plain = PQCodec.fit(x, m=8, nbits=4, iters=10, seed=3, device=CPU)
    opq = PQCodec.fit(x, m=8, nbits=4, iters=10, seed=3, opq_iters=8, device=CPU)
    np.testing.assert_allclose(opq.rotation @ opq.rotation.T, np.eye(32), atol=1e-4)
    mse_plain = ((plain.decode(plain.encode(x, device=CPU)) - x) ** 2).mean()
    mse_opq = ((opq.decode(opq.encode(x, device=CPU)) - x) ** 2).mean()
    assert mse_opq < 0.9 * mse_plain, (mse_opq, mse_plain)


def test_opq_rotation_persists_across_packages(tmp_path):
    x = correlated(np.random.RandomState(35), n=800)
    codec = PQCodec.fit(x, m=8, nbits=4, iters=6, seed=2, opq_iters=4, device=CPU)
    codec.save(str(tmp_path))
    theirs = jpq.PQCodec.load(str(tmp_path))
    np.testing.assert_array_equal(theirs.rotation, codec.rotation)
    np.testing.assert_array_equal(theirs.lut(x[:4]), codec.lut(x[:4]))
    ours = PQCodec.load(str(tmp_path))
    np.testing.assert_array_equal(ours.encode(x[:64], device=CPU),
                                  codec.encode(x[:64], device=CPU))
    # a JAX-fitted OPQ codec encodes alike in the port (f32 assignment)
    jc = jpq.PQCodec.fit(x, m=8, nbits=4, iters=6, seed=2, opq_iters=2)
    jc.save(str(tmp_path / "j"))
    got = PQCodec.load(str(tmp_path / "j")).encode(x, device=CPU)
    assert (got == jc.encode(x)).mean() > 0.999


def test_pack_unpack_roundtrip_and_validation():
    codes = np.random.RandomState(5).randint(0, 16, size=(37, 8)).astype(np.uint8)
    packed = tpq.pack_codes_4bit(codes)
    np.testing.assert_array_equal(packed, jpq.pack_codes_4bit(codes))
    np.testing.assert_array_equal(tpq.unpack_codes_4bit(packed), codes)
    np.testing.assert_array_equal(tpq.unpack_codes_4bit_dev(t(packed)).numpy(), codes)
    with pytest.raises(ValueError, match="4 bits"):
        tpq.pack_codes_4bit(np.full((2, 4), 16, np.uint8))
    with pytest.raises(ValueError, match="even"):
        tpq.pack_codes_4bit(np.zeros((2, 5), np.uint8))


@pytest.mark.parametrize("block_rows", [1 << 18, 256])
def test_flat_topk_packed_matches_unpacked(codec_problem, block_rows):
    _, queries, codec, codes = codec_problem
    lut = t(codec.lut(queries))
    s_u, i_u = pq_flat_topk(lut, t(codes), 20, codec.ksub, block_rows=block_rows)
    s_p, i_p = pq_flat_topk(lut, t(tpq.pack_codes_4bit(codes)), 20, codec.ksub,
                            block_rows=block_rows, packed=True)
    assert torch.equal(s_u, s_p) and torch.equal(i_u, i_p)
    with pytest.raises(ValueError, match="nbits=4 only"):
        pq_flat_topk(torch.zeros((2, 8, 256)), t(codes[:, :4]), 5, 256, packed=True)


# ---------------------------------------------------------------------------
# PQIndex
# ---------------------------------------------------------------------------
def test_search_matches_adc_oracle_and_jax(built):
    x, index, queries = built
    s, i = index.search(queries, 9, exact=True)
    assert_topk_set_equal(s, i, *pq_adc_oracle(index.codec.lut(queries), index.codes, 9))
    ref = JaxPQIndex(jpq.PQCodec(index.codec.codebooks, 4), index.codes)
    js, ji = ref.search(queries, 9)
    s, i = index.search(queries, 9)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-5)


def test_rowid_payloads_and_self_retrieval(built):
    x, index, queries = built
    offsets = np.arange(800, dtype=np.int32) * 7 + 3
    with_ids = PQIndex(index.codec, index.codes, offsets, device=CPU)
    s, i = with_ids.search(queries, 5, exact=True)
    base_s, base_pos = index.search(queries, 5, exact=True)
    np.testing.assert_array_equal(i, np.where(base_pos >= 0, base_pos * 7 + 3, -1))
    np.testing.assert_array_equal(s, base_s)
    _, top3 = index.search(x[:20], 3)
    assert np.mean([(q in top3[q]) for q in range(20)]) >= 0.9


def test_rescore_in_memory_recovers_exact(built):
    x, index, queries = built
    k = 6
    s, i = index.search(queries, k, rescore_factor=-(-800 // k), rescore_passages=x)
    want_s, want_i = topk_oracle(queries, x, k)
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, want_i)
    with pytest.raises(ValueError):
        index.search(queries, 5, rescore_factor=2)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("pack", [False, True])
def test_index_dir_cross_loads(tmp_path, built, writer, pack):
    x, index, queries = built
    d = str(tmp_path / "pqidx")
    assert not is_pq_index_dir(d)
    if writer == "jax":
        JaxPQIndex.build(x, m=8, nbits=4, iters=8, seed=1, pack=pack).save(d)
    else:
        PQIndex.build(x, m=8, nbits=4, iters=8, seed=1, pack=pack, device=CPU).save(d)
    assert is_pq_index_dir(d)
    ours, theirs = PQIndex.load(d, device=CPU), JaxPQIndex.load(d)
    assert ours.packed is pack
    s0, i0 = ours.search(queries, 8)
    s1, i1 = theirs.search(queries, 8)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-5, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        PQIndex.load(str(tmp_path / "nope"))


def test_build_from_blocks_and_block_rescore(tmp_path):
    x = corpus(seed=5, n=500)
    offsets = np.arange(500, dtype=np.int64) * 3 + 11
    d = str(tmp_path / "blocks")
    for b in range(2):
        write_embedding_block(d, b, x[b::2], offsets[b::2])
    index = PQIndex.build_from_blocks(d, m=8, nbits=4, iters=6, seed=0, device=CPU)
    assert index.ntotal == 500 and index.stats["block_sizes"] == [250, 250]
    queries = x[:6]
    x_concat = np.concatenate([x[0::2], x[1::2]])
    off_concat = np.concatenate([offsets[0::2], offsets[1::2]])
    _, pos = index.adc_topk(queries, 500, exact=True)
    s, ids = index.rescore_block_pass(d, queries, pos, 4)
    want_s, want_pos = topk_oracle(queries, x_concat, 4)
    np.testing.assert_allclose(s, want_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ids, off_concat[want_pos].astype(np.int32))
    # the JAX streaming pass over the same positions: bit-equal
    js, jids = JaxPQIndex.rescore_block_pass(index, d, queries, pos, 4)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(ids, jids)


def test_build_from_blocks_int8(tmp_path):
    x = corpus(seed=6, n=300)
    quant = Int8Quantizer.fit(x)
    d = str(tmp_path / "blocks_i8")
    for b in range(2):
        write_embedding_block(d, b, quant.quantize_passages(x[b::2]),
                              np.arange(300, dtype=np.int64)[b::2])
    quant.save(d)
    index = PQIndex.build_from_blocks(d, m=8, nbits=4, iters=5, seed=0, device=CPU)
    assert index.ntotal == 300
    _, i = index.search(x[:10], 3)
    assert np.mean([(q in i[q]) for q in range(10)]) >= 0.8


def test_validation_errors_and_world1_mesh_equals_unmeshed(built):
    x, index, _ = built
    with pytest.raises(ValueError):
        PQIndex(index.codec, index.codes.astype(np.int32))
    with pytest.raises(ValueError):
        PQIndex(index.codec, index.codes[:, :4])
    with pytest.raises(ValueError):
        PQIndex(index.codec, index.codes, np.arange(3, dtype=np.int32))
    with pytest.raises(ValueError):
        index.search(np.zeros((2, 7), np.float32), 3)
    with pytest.raises(TypeError, match="DeviceMesh"):
        index.search(x[:2], 3, mesh=object())
    want = index.search(x[:5], 7)
    with single_rank():
        got = index.search(x[:5], 7, mesh=get_mesh(("index",)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    codec8 = PQCodec.fit(x, m=8, nbits=8, iters=2, seed=1, device=CPU)
    with pytest.raises(ValueError, match="nbits=4 only"):
        PQIndex(codec8, np.zeros((4, 4), np.uint8), packed=True)


def test_packed_index_matches_unpacked(tmp_path, built):
    x, index, queries = built
    packed = PQIndex.build(x, m=8, nbits=4, codec=index.codec, pack=True, device=CPU)
    assert packed.code_bytes == 4 and packed.codes.nbytes == index.codes.nbytes // 2
    s_u, i_u = index.search(queries, 15)
    s_p, i_p = packed.search(queries, 15)
    np.testing.assert_array_equal(s_u, s_p)
    np.testing.assert_array_equal(i_u, i_p)


# ---------------------------------------------------------------------------
# IVFPQ
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("storage", ["pq4", "pq8"])
def test_ivfpq_full_probe_matches_adc_oracle(storage):
    x = corpus(seed=21, n=600, d=32)
    idx = IVFIndex.build(x, nlist=6, storage_dtype=storage, pq_m=8, iters=6, seed=0, device=CPU)
    assert idx.lists.dtype == np.uint8 and idx.lists.shape[2] == 8 and idx.dim == 32
    queries = x[:6]
    s, i = idx.search(queries, 7, nprobe=idx.nlist, exact=True)
    codes = idx.codec.encode(x, device=CPU)
    want_s, want_i = pq_adc_oracle(idx.codec.lut(queries), codes, 7)
    np.testing.assert_allclose(np.sort(s, 1), np.sort(want_s, 1), rtol=1e-5, atol=1e-5)
    for q in range(6):
        assert set(i[q].tolist()) == set(want_i[q].tolist())


def test_ivfpq_recall_on_clustered_corpus():
    rng = np.random.Generator(np.random.PCG64(5))
    centers = rng.standard_normal((12, 32), dtype=np.float32)
    x = centers[rng.integers(0, 12, size=1500)] + 0.25 * rng.standard_normal(
        (1500, 32), dtype=np.float32
    )
    idx = IVFIndex.build(x, nlist=12, storage_dtype="pq8", pq_m=8, iters=8, seed=0, device=CPU)
    queries = x[:10] + 0.05 * rng.standard_normal((10, 32), dtype=np.float32)
    _, want = topk_oracle(queries, x, 10)
    _, got = idx.search(queries, 30, nprobe=4)
    assert np.mean([len(set(got[q]) & set(want[q])) / 10.0 for q in range(10)]) >= 0.6


def test_ivfpq_build_from_blocks_and_int8_blocks(tmp_path):
    x = corpus(seed=25, n=500, d=32)
    offsets = np.arange(500, dtype=np.int64) * 2 + 7
    d = str(tmp_path / "blocks")
    for b in range(2):
        write_embedding_block(d, b, x[b::2], offsets[b::2])
    idx = IVFIndex.build_from_blocks(d, 6, storage_dtype="pq4", pq_m=8, iters=5, seed=0,
                                     device=CPU)
    assert idx.ntotal == 500 and idx.storage_dtype == "pq4"
    _, ids = idx.search(x[:5], 3, nprobe=idx.nlist)
    assert set(ids.ravel().tolist()) <= set(offsets.tolist())
    quant = Int8Quantizer.fit(x)
    d8 = str(tmp_path / "blocks_i8")
    for b in range(2):
        write_embedding_block(d8, b, quant.quantize_passages(x[b::2]), offsets[b::2])
    quant.save(d8)
    idx8 = IVFIndex.build_from_blocks(d8, 6, storage_dtype="pq4", pq_m=8, iters=5, seed=0,
                                      device=CPU)
    assert idx8.ntotal == 500 and idx8.codec is not None


def test_ivfpq_packed_lists_match_unpacked(tmp_path):
    rng = np.random.Generator(np.random.PCG64(77))
    centers = rng.standard_normal((16, 32), dtype=np.float32)
    x = (centers[rng.integers(0, 16, size=2000)]
         + 0.1 * rng.standard_normal((2000, 32))).astype(np.float32)
    q = x[rng.choice(2000, 8, replace=False)] + 0.02 * rng.standard_normal(
        (8, 32)).astype(np.float32)
    a = IVFIndex.build(x, 16, storage_dtype="pq4", pq_m=8, iters=6, seed=0, device=CPU)
    b = IVFIndex.build(x, 16, storage_dtype="pq4", pq_m=8, iters=6, seed=0, pack=True,
                       device=CPU)
    assert b.packed and b.lists.nbytes == a.lists.nbytes // 2
    s_a, i_a = a.search(q, 10, nprobe=4)
    s_b, i_b = b.search(q, 10, nprobe=4)
    np.testing.assert_array_equal(s_a, s_b)
    np.testing.assert_array_equal(i_a, i_b)
    b.save(str(tmp_path / "packed"))
    loaded = IVFIndex.load(str(tmp_path / "packed"), device=CPU)
    assert loaded.packed
    s_l, i_l = loaded.search(q, 10, nprobe=4)
    np.testing.assert_array_equal(s_l, s_b)
    np.testing.assert_array_equal(i_l, i_b)
    with pytest.raises(ValueError, match="pq4 storage only"):
        IVFIndex.build(x, 4, storage_dtype="int8", pack=True, device=CPU)
