"""convdr_torch's int8 (SQ8) search against the JAX package (CPU).

Mirrors every case of ``tests/test_quant.py`` that runs on one device: the
port's quantizer equals the JAX one array for array, its int8
``flat_ip_topk`` equals ``int8_topk_oracle`` bit for bit (scores included),
and its ``BlockedSearcher`` gives the JAX ``BlockedSearcher``'s offsets AND
scores bit-identically for int8 arrays, int8 blocks with their sidecar,
float blocks that self-fit, device quantization and host rescoring; the
rescore rejections raise the same errors. Then both packages' drivers run
``--storage_dtype int8`` end to end on one tiny chain.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.ops import exact_search as tes
from convdr_torch.ops import quant as tq
from convdr_torch.retrieval.blocks import iter_embedding_blocks as torch_iter
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.ops import exact_search as jes
from convdr_tpu.ops import quant as jq
from convdr_tpu.retrieval.blocks import iter_embedding_blocks as jax_iter
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxSearcher
from test_torch_pipeline import chain, embed_args, embedded, infer_args  # noqa: F401

CPU = torch.device("cpu")


def quantized_problem(rng, q=9, n=700, d=48):
    queries = rng.randn(q, d).astype(np.float32)
    passages = rng.randn(n, d).astype(np.float32)
    quant = tq.Int8Quantizer.fit(passages)
    p_i8 = quant.quantize_passages(passages)
    q_int, t_q = quant.quantize_queries(queries)
    return queries, passages, quant, p_i8, q_int, t_q


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def searchers(**cfg):
    """The port's and the JAX package's searcher on one configuration."""
    return (BlockedSearcher(SearchConfig(**cfg), device=CPU),
            JaxSearcher(JaxSearchConfig(**cfg)))


# ---------------------------------------------------------------------------
# quantizer mechanics
# ---------------------------------------------------------------------------
def test_quantizer_equals_jax(rng):
    p = rng.randn(300, 16).astype(np.float32) * rng.rand(16).astype(np.float32)
    p[:, 3] = 0.0  # an all-zero dimension
    q = rng.randn(7, 16).astype(np.float32)
    q[2] = 0.0  # an all-zero query
    s = tq.fit_int8_scales(p)
    np.testing.assert_array_equal(s, jq.fit_int8_scales(p))
    np.testing.assert_array_equal(tq.quantize_passages(p, s), jq.quantize_passages(p, s))
    for a, b in zip(tq.quantize_queries(q, s), jq.quantize_queries(q, s)):
        np.testing.assert_array_equal(a, b)
    assert tq.INT8_EXACT_MAX_DIM == jq.INT8_EXACT_MAX_DIM >= 768
    assert tq.INT8_SCALES_FILENAME == jq.INT8_SCALES_FILENAME


def test_fit_scales_cover_sample(rng):
    p = rng.randn(200, 16).astype(np.float32)
    s = tq.fit_int8_scales(p)
    q = tq.quantize_passages(p, s)
    assert q.dtype == np.int8 and np.abs(q).max() <= 127
    err = np.abs(q.astype(np.float32) * s[None, :] - p)
    assert np.all(err <= s[None, :] * 0.5 + 1e-6)
    with pytest.raises(ValueError):
        tq.fit_int8_scales(np.zeros((0, 4), np.float32))


def test_fit_scales_zero_dim_safe():
    p = np.zeros((10, 4), np.float32)
    p[:, 0] = 3.0
    s = tq.fit_int8_scales(p)
    assert s[0] == pytest.approx(3.0 / 127) and np.all(s[1:] == 1.0)
    assert np.all(tq.quantize_passages(p, s)[:, 1:] == 0)


def test_quantize_queries_int_valued_and_rank_safe(rng):
    _queries, _p, _quant, _p_i8, q_int, t_q = quantized_problem(rng)
    assert np.array_equal(q_int, np.rint(q_int)) and np.abs(q_int).max() <= 127
    assert np.all(t_q > 0)


def test_device_quantize_equals_host_half_to_even(rng):
    p = rng.randn(500, 8).astype(np.float32)
    p[:40] = np.round(p[:40] * 4) / 4  # on and near quarter steps
    scales = tq.fit_int8_scales(p)
    scales[:4] = 0.5  # p / 0.5 lands on exact halves: round half to even
    got = tq.quantize_passages_dev(t(p), t(scales)).numpy()
    np.testing.assert_array_equal(got, tq.quantize_passages(p, scales))
    np.testing.assert_array_equal(got, jq.quantize_passages(p, scales))
    assert (np.abs(p[:40, :4] / 0.5 % 1) == 0.5).any()  # halves were hit


def test_int8_oracle_equals_jax(rng):
    _queries, _p, _quant, p_i8, q_int, _tq = quantized_problem(rng, n=300)
    for a, b in zip(tq.int8_topk_oracle(q_int, p_i8, 40), jq.int8_topk_oracle(q_int, p_i8, 40)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# engine: the int8 path of flat_ip_topk equals the integer oracle
# ---------------------------------------------------------------------------
def test_flat_ip_topk_int8_matches_int_oracle(rng):
    _q, _p, _quant, p_i8, q_int, _tq = quantized_problem(rng)
    os_, oi = tq.int8_topk_oracle(q_int, p_i8, 25)
    s, i = tes.flat_ip_topk(t(q_int), t(p_i8), 25)
    np.testing.assert_array_equal(i.numpy(), oi)
    np.testing.assert_array_equal(s.numpy(), os_)  # integer-exact
    js, ji = jes.flat_ip_topk(jnp.asarray(q_int), jnp.asarray(p_i8), 25)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_flat_ip_topk_int8_blocked_scan_and_valid_rows(rng):
    _q, _p, _quant, p_i8, q_int, _tq = quantized_problem(rng, n=603)
    extra = rng.randint(-127, 127, (37, p_i8.shape[1])).astype(np.int8)
    padded = np.concatenate([p_i8, extra])
    os_, oi = tq.int8_topk_oracle(q_int, p_i8, 40)
    for gather in ("auto", "dma"):
        s, i = tes.flat_ip_topk(
            t(q_int), t(padded), 40, block_rows=128, valid_rows=603, gather=gather
        )
        np.testing.assert_array_equal(i.numpy(), oi)
        np.testing.assert_array_equal(s.numpy(), os_)


# ---------------------------------------------------------------------------
# rescore (IndexRefineFlat parity)
# ---------------------------------------------------------------------------
def test_rescore_candidates_full_set_equals_oracle_and_jax(rng):
    q = rng.randn(5, 24).astype(np.float32)
    p = rng.randn(80, 24).astype(np.float32)
    idx = np.stack([rng.permutation(80) for _ in range(5)])
    idx = np.concatenate([idx, np.full((5, 7), -1)], axis=1)
    s, i = tq.rescore_candidates(q, p, idx, 10)
    os_, oi = tes.topk_oracle(q, p, 10)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(s, os_, rtol=1e-6)
    for a, b in zip((s, i), jq.rescore_candidates(q, p, idx, 10)):
        np.testing.assert_array_equal(a, b)


def test_rescore_tie_break_low_index():
    q = np.ones((1, 4), np.float32)
    p = np.zeros((6, 4), np.float32)
    p[[2, 4]] = 1.0
    _s, i = tq.rescore_candidates(q, p, np.asarray([[5, 4, 3, 2, 1]]), 2)
    assert list(i[0]) == [2, 4]


def test_rescore_pads_when_candidates_short():
    q = np.ones((2, 4), np.float32)
    p = np.ones((3, 4), np.float32)
    s, i = tq.rescore_candidates(q, p, np.asarray([[0, 2, -1], [1, -1, -1]]), 4)
    assert i.shape == (2, 4) and list(i[0]) == [0, 2, -1, -1]
    assert s[0, 2] == tes.NEG_INF


# ---------------------------------------------------------------------------
# searcher integration, against the JAX BlockedSearcher
# ---------------------------------------------------------------------------
def assert_same(ours, ref):
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_search_arrays_int8_matches_jax_and_int_oracle(rng):
    queries, passages, quant, p_i8, q_int, t_q = quantized_problem(rng)
    ours = BlockedSearcher(SearchConfig(storage_dtype="int8"), device=CPU, quantizer=quant)
    ref = JaxSearcher(JaxSearchConfig(storage_dtype="int8"),
                      quantizer=jq.Int8Quantizer(quant.scales))
    got = ours.search_arrays(queries, passages, np.arange(700) * 3, 20)
    assert_same(got, ref.search_arrays(queries, passages, np.arange(700) * 3, 20))
    os_, oi = tq.int8_topk_oracle(q_int, p_i8, 20)
    np.testing.assert_array_equal(got[1], oi * 3)
    np.testing.assert_allclose(got[0], os_ * t_q, rtol=1e-6)  # tq-rescaled ints


def test_search_arrays_int8_device_quantize_matches_host(rng):
    # float corpus under an int8 config: quantized on the device, equal to
    # the host quantizer (and self-fitted, as in the JAX searcher)
    queries, passages, _quant, _p_i8, _q_int, _tq = quantized_problem(rng, n=450)
    ours, ref = searchers(storage_dtype="int8", passage_block_size=128)
    got = ours.search_arrays(queries, passages, np.arange(450), 15)
    assert_same(got, ref.search_arrays(queries, passages, np.arange(450), 15))
    q_int2, _ = ours.quantizer.quantize_queries(queries)
    _os, oi = tq.int8_topk_oracle(q_int2, ours.quantizer.quantize_passages(passages), 15)
    np.testing.assert_array_equal(got[1], oi)


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_search_arrays_rescore_recovers_f32_oracle(rng, storage):
    queries, passages, _quant, _p_i8, _q_int, _tq = quantized_problem(rng, n=400)
    ours, ref = searchers(storage_dtype=storage, rescore_factor=40)
    got = ours.search_arrays(queries, passages, np.arange(400), 10)
    assert_same(got, ref.search_arrays(queries, passages, np.arange(400), 10))
    os_, oi = tes.topk_oracle(queries, passages, 10)
    np.testing.assert_array_equal(got[1], oi)
    np.testing.assert_allclose(got[0], os_, rtol=1e-6)


def test_search_arrays_int8_overlap_reasonable(rng):
    queries, passages, quant, _p_i8, _q_int, _tq = quantized_problem(rng, q=16, n=2000, d=64)
    ours = BlockedSearcher(SearchConfig(storage_dtype="int8"), device=CPU, quantizer=quant)
    _s, offs = ours.search_arrays(queries, passages, np.arange(2000), 10)
    _os, oi = tes.topk_oracle(queries, passages, 10)
    overlap = np.mean([len(set(offs[i]) & set(oi[i])) for i in range(16)]) / 10
    assert overlap >= 0.8, overlap


def test_search_blocks_int8_blocks_with_sidecar(rng, tmp_path):
    queries, passages, quant, p_i8, q_int, t_q = quantized_problem(rng, n=640)
    d = str(tmp_path)
    write_embedding_block(d, 0, p_i8[:320], np.arange(320) * 2)
    write_embedding_block(d, 1, p_i8[320:], (320 + np.arange(320)) * 2)
    quant.save(d)
    ours, ref = searchers(storage_dtype="int8")
    got = ours.search_blocks(d, queries, 25)
    assert_same(got, ref.search_blocks(d, queries, 25))
    os_, oi = tq.int8_topk_oracle(q_int, p_i8, 25)
    np.testing.assert_array_equal(got[1], oi * 2)
    np.testing.assert_allclose(got[0], os_ * t_q, rtol=1e-6)
    # the JAX package reads the port's int8 blocks and sidecar as written
    for (_b, emb, _ids), half in zip(jax_iter(d), (p_i8[:320], p_i8[320:])):
        assert emb.dtype == np.int8 and np.array_equal(emb, half)
    np.testing.assert_array_equal(jq.Int8Quantizer.load(d).scales, quant.scales)


def test_search_blocks_int8_blocks_without_sidecar_raises(rng, tmp_path):
    _q, _p, _quant, p_i8, _qi, _tq = quantized_problem(rng, n=100)
    d = str(tmp_path)
    write_embedding_block(d, 0, p_i8, np.arange(100))
    ours = BlockedSearcher(SearchConfig(storage_dtype="int8"), device=CPU)
    with pytest.raises(FileNotFoundError, match="sidecar"):
        ours.search_blocks(d, np.zeros((2, p_i8.shape[1]), np.float32), 5)


def test_search_blocks_float_blocks_int8_config_self_fits(rng, tmp_path, caplog):
    queries, passages, _quant, _p_i8, _qi, _tq = quantized_problem(rng, n=500)
    d = str(tmp_path)
    write_embedding_block(d, 0, passages[:250], np.arange(250))
    write_embedding_block(d, 1, passages[250:], 250 + np.arange(250))
    ours, ref = searchers(storage_dtype="int8")
    with caplog.at_level("WARNING"):
        got = ours.search_blocks(d, queries, 20)
    assert "fitting scales on block 0" in caplog.text
    assert_same(got, ref.search_blocks(d, queries, 20))
    np.testing.assert_array_equal(ours.quantizer.scales, tq.fit_int8_scales(passages[:250]))
    q_int, _ = ours.quantizer.quantize_queries(queries)
    _os, oi = tq.int8_topk_oracle(q_int, ours.quantizer.quantize_passages(passages), 20)
    np.testing.assert_array_equal(got[1], oi)


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_search_blocks_rescore_from_float_blocks(rng, tmp_path, storage):
    queries, passages, _quant, _p_i8, _qi, _tq = quantized_problem(rng, n=300)
    d = str(tmp_path)
    write_embedding_block(d, 0, passages[:150], np.arange(150))
    write_embedding_block(d, 1, passages[150:], 150 + np.arange(150))
    ours, ref = searchers(storage_dtype=storage, rescore_factor=30)
    got = ours.search_blocks(d, queries, 10)
    assert_same(got, ref.search_blocks(d, queries, 10))
    os_, oi = tes.topk_oracle(queries, passages, 10)
    np.testing.assert_array_equal(got[1], oi)
    np.testing.assert_allclose(got[0], os_, rtol=1e-6)


def test_search_blocks_rescore_rejects_int8_blocks(rng, tmp_path):
    _q, _p, quant, p_i8, _qi, _tq = quantized_problem(rng, n=100)
    d = str(tmp_path)
    write_embedding_block(d, 0, p_i8, np.arange(100))
    quant.save(d)
    ours = BlockedSearcher(SearchConfig(storage_dtype="int8", rescore_factor=2), device=CPU)
    with pytest.raises(ValueError, match="float block"):
        ours.search_blocks(d, np.zeros((2, p_i8.shape[1]), np.float32), 5)


def test_search_arrays_rescore_rejects_int8_corpus(rng):
    queries, _p, quant, p_i8, _qi, _tq = quantized_problem(rng, n=100)
    ours = BlockedSearcher(
        SearchConfig(storage_dtype="int8", rescore_factor=2), device=CPU, quantizer=quant
    )
    with pytest.raises(ValueError, match="original float rows"):
        ours.search_arrays(queries, p_i8, np.arange(100), 5)
    bare = BlockedSearcher(SearchConfig(storage_dtype="int8"), device=CPU)
    with pytest.raises(ValueError, match="needs fitted scales"):
        bare.search_arrays(queries, p_i8, np.arange(100), 5)


def test_quantizer_save_load_roundtrip(tmp_path, rng):
    quant = tq.Int8Quantizer.fit(rng.randn(50, 12).astype(np.float32))
    quant.save(str(tmp_path))
    again = tq.Int8Quantizer.load(str(tmp_path))
    np.testing.assert_array_equal(again.scales, quant.scales)
    assert tq.Int8Quantizer.load_optional(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError, match="sidecar"):
        tq.Int8Quantizer.load(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# the drivers end to end
# ---------------------------------------------------------------------------
def test_drivers_int8_end_to_end(embedded):
    from convdr_torch.drivers import gen_passage_embeddings as torch_embed
    from convdr_torch.drivers import run_convdr_inference as torch_infer
    from convdr_tpu.drivers import run_convdr_inference as jax_infer

    # the port's int8 embed = its own float embed, quantized (scales fitted
    # on block 0), with the sidecar beside the blocks
    torch_embed.main(embed_args(embedded, "torch_i8") + ["--no_cuda", "--storage_dtype", "int8"])
    floats = list(torch_iter(str(embedded / "torch_emb")))
    quant = tq.Int8Quantizer.load(str(embedded / "torch_i8"))
    np.testing.assert_array_equal(quant.scales, tq.fit_int8_scales(floats[0][1]))
    for (_b, e8, i8), (_b2, ef, idf) in zip(torch_iter(str(embedded / "torch_i8")), floats):
        assert e8.dtype == np.int8
        np.testing.assert_array_equal(e8, quant.quantize_passages(ef))
        np.testing.assert_array_equal(i8, idf)

    # one set of f32 blocks, quantized by both packages: the same int8 dir
    jax_blocks = list(jax_iter(str(embedded / "jax_emb")))
    jquant = jq.Int8Quantizer.fit(jax_blocks[0][1])
    tquant = tq.Int8Quantizer.fit(jax_blocks[0][1])
    np.testing.assert_array_equal(jquant.scales, tquant.scales)
    i8_dir = str(embedded / "shared_i8")
    for b, emb, ids in jax_blocks:
        p8 = tquant.quantize_passages(emb)
        np.testing.assert_array_equal(p8, jquant.quantize_passages(emb))
        write_embedding_block(i8_dir, b, p8, ids)
    tquant.save(i8_dir)
    int8 = ["--storage_dtype", "int8"]
    means_jax = jax_infer.main(infer_args(embedded, "shared_i8", "jax_i8", "--no_mesh", *int8))
    means_torch = torch_infer.main(infer_args(embedded, "shared_i8", "torch_i8", "--no_cuda", *int8))
    assert (embedded / "torch_i8.trec").read_bytes() == (embedded / "jax_i8.trec").read_bytes()
    assert means_torch == means_jax

    # int8 over the f32 blocks (device SQ8, self-fit) refined on the host:
    # 2 x top_n candidates cover each 12-row block, so the run is the f32 run
    rescore = int8 + ["--rescore_factor", "2"]
    jax_infer.main(infer_args(embedded, "jax_emb", "jax_rs", "--no_mesh", *rescore))
    torch_infer.main(infer_args(embedded, "jax_emb", "torch_rs", "--no_cuda", *rescore))
    torch_infer.main(infer_args(embedded, "jax_emb", "torch_f32", "--no_cuda"))
    assert (embedded / "torch_rs.trec").read_bytes() == (embedded / "jax_rs.trec").read_bytes()
    assert (embedded / "torch_rs.trec").read_bytes() == (embedded / "torch_f32.trec").read_bytes()
    assert not os.path.exists(embedded / "jax_emb" / tq.INT8_SCALES_FILENAME)


def test_rescore_with_float32_storage_exits(chain):
    from convdr_torch.drivers import run_convdr_inference as torch_infer

    with pytest.raises(SystemExit, match="already exact"):
        torch_infer.main(infer_args(chain, "jax_emb", "never", "--no_cuda",
                                    "--rescore_factor", "2"))

