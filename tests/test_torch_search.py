"""convdr_torch exact search against the JAX package (CPU).

The port's plain score + group-max stage is held to the JAX Pallas kernel in
interpret mode at the edges of the card kernel's tiles (scores within 1e-5
at D=32, scaled by D/32 beyond: another f32 summation order; group maxima
equal to the max of each group exactly), and its int8 scores to the JAX
int8 search and the integer oracle exactly. The searches must return
IDENTICAL f32 top-k indices to the JAX ``flat_ip_topk`` and the numpy
oracle, including the tie, ``valid_rows``, ``k > n``, multi-block merge and
sub-block split cases of ``tests/test_exact_search.py``,
``tests/test_pallas_search.py`` and ``tests/test_retrieval.py``; bf16
storage must give the same top-k set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.ops import exact_search as tes
from convdr_torch.ops import fused_search as tfs
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.ops import exact_search as jes
from convdr_tpu.ops.pallas_search import fused_scores_groupmax, pallas_flat_ip_topk
from convdr_tpu.retrieval.blocks import iter_embedding_blocks as jax_iter_blocks
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxSearcher

CPU = torch.device("cpu")


def problem(seed, q=5, n=500, d=32):
    rng = np.random.RandomState(seed)
    return rng.randn(q, d).astype(np.float32), rng.randn(n, d).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def port_topk(q, p, k, **kw):
    s, i = tes.flat_ip_topk(t(q), t(p), k, **kw)
    return s.numpy(), i.numpy()


# (Q, N, D) at the edges of the card kernel's tiles (128 or 64 queries x 128
# rows, D padded to 16 bytes of the passages; the small-Q path's query
# buckets at Q <= 32), at CPU sizes
EDGE_SHAPES = [(4, 256, 32), (1, 128, 8), (63, 384, 100), (64, 384, 8),
               (65, 128, 768), (129, 384, 100), (2, 256, 32), (16, 384, 100),
               (17, 128, 768)]


@pytest.mark.parametrize("qn,n,d", EDGE_SHAPES)
@pytest.mark.parametrize("group", [8, 16, 32])
def test_plain_scores_groupmax_matches_pallas_interpret(group, qn, n, d):
    q, p = problem(0, q=qn, n=n, d=d)
    scores, gmax = tfs.fused_scores_groupmax(t(q), t(p), group)
    js, jg = fused_scores_groupmax(
        jnp.asarray(q), jnp.asarray(p), group=group, tile_rows=128, interpret=True
    )
    # another f32 summation order: 1e-5 at D=32, the worst-case rounding
    # error of a dot product growing linearly with D
    atol = 1e-5 * max(1.0, d / 32)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=atol, rtol=0)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(jg), atol=atol, rtol=0)
    np.testing.assert_array_equal(
        gmax.numpy(), scores.numpy().reshape(qn, n // group, group).max(-1)
    )
    assert tfs.fused_scores_groupmax.launches == 0  # CPU: plain version


# int8 (Q, N, D): the card kernel's tiles (128 queries in two warpgroups of
# 64, 128- or 256-row passage tiles, 128 bytes of k a stage) at CPU sizes;
# the PM127 shapes fill every element with +-127 at D=1040, the largest D
# whose sums stay exact in f32 (1040 * 127^2 < 2^24)
PM127_SHAPES = [(65, 384, 1040)]
INT8_SHAPES = [(1, 128, 8), (65, 384, 100), (129, 384, 768), (3, 128, 1040),
               (1, 4224, 16), (63, 128, 112), (64, 384, 1040), (257, 384, 112),
               (512, 128, 1040), *PM127_SHAPES]


@pytest.mark.parametrize("qn,n,d", INT8_SHAPES)
def test_plain_int8_scores_match_jax_int8_search(qn, n, d):
    """int8 passages with int-valued queries: the plain scores are exact
    integers, equal to the JAX int8 ``flat_ip_topk``'s scores and to the
    integer oracle; the plain kernels 2 and 3 equal the JAX package's
    Pallas ``fused_scores_groupmax`` and ``streaming_groupmax`` (interpret
    mode) at G = 8, 32, 128 (the card kernel is held to this plain
    version)."""
    from convdr_torch.ops.quant import Int8Quantizer
    from convdr_torch.ops.streaming_search import streaming_groupmax as port_streaming
    from convdr_tpu.ops.pallas_search import streaming_groupmax as jax_streaming

    if (qn, n, d) in PM127_SHAPES:
        rng = np.random.RandomState(7)
        q_int = 127.0 * rng.choice([-1.0, 1.0], (qn, d)).astype(np.float32)
        p_i8 = (127 * rng.choice([-1, 1], (n, d))).astype(np.int8)
        q_int[0], p_i8[0] = 127.0, 127  # the largest sum there is
    else:
        q, p = problem(1, q=qn, n=n, d=d)
        quant = Int8Quantizer.fit(p)
        p_i8 = quant.quantize_passages(p)
        q_int = quant.quantize_queries(q)[0]
    exact = (q_int.astype(np.int64) @ p_i8.astype(np.int64).T).astype(np.float32)
    for group in (8, 32, 128):
        scores, gmax = tfs.fused_scores_groupmax(t(q_int), t(p_i8), group)
        np.testing.assert_array_equal(scores.numpy(), exact)
        np.testing.assert_array_equal(gmax.numpy(), exact.reshape(qn, -1, group).max(-1))
        js, jg = fused_scores_groupmax(jnp.asarray(q_int), jnp.asarray(p_i8), group=group,
                                       tile_rows=128, interpret=True)
        np.testing.assert_array_equal(scores.numpy(), np.asarray(js))
        np.testing.assert_array_equal(gmax.numpy(), np.asarray(jg))
        jm = jax_streaming(jnp.asarray(q_int), jnp.asarray(p_i8), group=group, tile_rows=128,
                           interpret=True)
        np.testing.assert_array_equal(port_streaming(t(q_int), t(p_i8), group).numpy(),
                                      np.asarray(jm))
    if (qn, n, d) in PM127_SHAPES:
        assert exact[0, 0] == 1040 * 127 ** 2
    js, ji = jes.flat_ip_topk(jnp.asarray(q_int), jnp.asarray(p_i8), n, block_rows=n)
    np.testing.assert_array_equal(
        np.take_along_axis(scores.numpy(), np.asarray(ji).astype(np.int64), 1), np.asarray(js)
    )
    assert tfs.fused_scores_groupmax.launches == 0  # CPU: plain version


def test_scores_groupmax_rejects_bad_group():
    q, p = problem(1, n=100)
    with pytest.raises(ValueError):
        tfs.fused_scores_groupmax(t(q), t(p), 32)


@pytest.mark.parametrize("block_rows", [64, 128, 500, 1000])
def test_flat_ip_matches_jax_and_oracle(block_rows):
    q, p = problem(2)
    os_, oi = jes.topk_oracle(q, p, 25)
    js, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), 25, block_rows=block_rows)
    s, i = port_topk(q, p, 25, block_rows=block_rows)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, os_, rtol=1e-5)


@pytest.mark.parametrize("block_rows", [128, 500])
def test_flat_ip_single_query_over_blocks_matches_jax(block_rows):
    """Q=1, the serving search's shape (the card's small-Q path), over
    several blocks: the same indices as the JAX ``flat_ip_topk`` and the
    oracle."""
    q, p = problem(4, q=1, n=1300, d=100)
    os_, oi = jes.topk_oracle(q, p, 100)
    js, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), 100, block_rows=block_rows)
    s, i = port_topk(q, p, 100, block_rows=block_rows)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, os_, rtol=1e-5)
    np.testing.assert_allclose(s, np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize(
    "n,winners,k,block_rows,group",
    [
        (300, (5, 64, 130, 290), 4, 128, 32),   # test_exact_search tie case
        (128, (3, 64, 100), 3, 65536, 8),       # test_pallas_search tie case
        (512, (5, 16, 255, 256, 400), 5, 65536, 16),  # streaming tie case
    ],
)
def test_tie_break_lower_index_first(n, winners, k, block_rows, group):
    q = np.ones((2, 8), np.float32)
    p = np.zeros((n, 8), np.float32)
    p[list(winners)] = 1.0
    _, i = port_topk(q, p, k, block_rows=block_rows, group=group)
    assert list(i[0]) == list(winners)
    _, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), k, block_rows=block_rows)
    np.testing.assert_array_equal(i, np.asarray(ji))


def test_fused_topk_tie_break_and_padding_match_pallas():
    q = np.ones((1, 8), np.float32)
    p = np.zeros((128, 8), np.float32)
    p[[3, 64, 100]] = 1.0
    _, i = tfs.fused_flat_ip_topk(t(q), t(p), 3, group=8)
    assert list(i.numpy()[0]) == [3, 64, 100]
    q, p = problem(3, q=3, n=200, d=16)  # 200 rows: padded to the row tile
    _, i = tfs.fused_flat_ip_topk(t(q), t(p), 50, group=8)
    _, ji = pallas_flat_ip_topk(
        jnp.asarray(q), jnp.asarray(p), 50, group=8, tile_rows=64, interpret=True
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), jes.topk_oracle(q, p, 50)[1])


def test_valid_rows_masks_padding():
    q, p = problem(4, q=3, n=100)
    padded = np.concatenate([p, np.zeros((28, p.shape[1]), np.float32)])
    os_, oi = jes.topk_oracle(q, p, 100)
    s, i = port_topk(q, padded, 100, block_rows=64, valid_rows=100)
    _, ji = jes.flat_ip_topk(
        jnp.asarray(q), jnp.asarray(padded), 100, block_rows=64, valid_rows=100
    )
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(i, np.asarray(ji))


@pytest.mark.parametrize("n,k,block_rows", [(3, 5, 65536), (64, 80, 65536), (100, 150, 32)])
def test_k_exceeds_n_pads_with_sentinels(n, k, block_rows):
    q, p = problem(5, q=2, n=n, d=8)
    os_, oi = jes.topk_oracle(q, p, k)
    s, i = port_topk(q, p, k, block_rows=block_rows)
    np.testing.assert_array_equal(i, oi)
    assert (i[:, n:] == -1).all() and (s[:, n:] == tes.NEG_INF).all()


def test_multi_block_merge_and_k_over_block_rows():
    q, p = problem(6, q=6, n=2560, d=16)
    os_, oi = jes.topk_oracle(q, p, 7)
    for block_rows in (320, 256):
        s, i = port_topk(q, p, 7, block_rows=block_rows)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_allclose(s, os_, rtol=1e-5)
    s, i = port_topk(q, p, 700, block_rows=320)  # k > 2 * block_rows
    np.testing.assert_array_equal(i, jes.topk_oracle(q, p, 700)[1])


def test_large_block_recursive_selection_matches_oracle():
    q, p = problem(7, q=4, n=150000, d=24)
    s, i = port_topk(q, p, 50, block_rows=150000)
    os_, oi = jes.topk_oracle(q, p, 50)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(s, os_, atol=2e-5)


@pytest.mark.parametrize("w", [100, 4095, 4097, 40000])
def test_grouped_topk_matches_stable_sort(w):
    x = np.random.RandomState(8).randn(5, w).astype(np.float32)
    ref_s, ref_i = tes.stable_topk(t(x), 100)
    got_s, got_i = tes.grouped_topk_last_axis(t(x), 100, group=32)
    assert torch.equal(got_s, ref_s) and torch.equal(got_i, ref_i)
    _, ji = jes.grouped_topk_last_axis(jnp.asarray(x), 100, group=32)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("group", [32, 128])
def test_grouped_topk_tie_storm(group):
    x = np.random.RandomState(9).randint(0, 4, size=(4, 50000)).astype(np.float32)
    ref_s, ref_i = tes.stable_topk(t(x), 128)
    got_s, got_i = tes.grouped_topk_last_axis(t(x), 128, group=group)
    assert torch.equal(got_s, ref_s) and torch.equal(got_i, ref_i)


def test_grouped_topk_boundary_ties():
    x = np.full((1, 20000), -1.0, np.float32)
    x[0, [5, 31, 32, 63, 9000, 9001, 12800, 19998, 19999]] = 3.5
    _, got_i = tes.grouped_topk_last_axis(t(x), 7, group=32)
    assert list(got_i.numpy()[0]) == [5, 31, 32, 63, 9000, 9001, 12800]


def test_merge_topk_prefers_first_list():
    s, i = tes.merge_topk(
        torch.tensor([[5.0, 3.0]]), torch.tensor([[10, 11]]),
        torch.tensor([[5.0, 4.0]]), torch.tensor([[20, 21]]), 3,
    )
    assert i.tolist() == [[10, 20, 21]] and s.tolist() == [[5.0, 5.0, 4.0]]


def test_oracle_matches_jax_oracle():
    q, p = problem(10, n=50)
    for a, b in zip(tes.topk_oracle(q, p, 60), jes.topk_oracle(q, p, 60)):
        np.testing.assert_array_equal(a, b)


def test_bf16_storage_same_set_as_jax():
    q, p = problem(11, q=4, n=400, d=64)
    p_bf16 = t(p).to(torch.bfloat16)
    s, i = tes.flat_ip_topk(t(q), p_bf16, 10, block_rows=128)
    _, ji = jes.flat_ip_topk(
        jnp.asarray(q), jnp.asarray(p, dtype=jnp.bfloat16), 10, block_rows=128
    )
    rounded = p_bf16.float().numpy()
    _, oi = jes.topk_oracle(q, rounded, 10)
    for r in range(4):
        assert set(i.numpy()[r]) == set(np.asarray(ji)[r]) == set(oi[r])


def make_blocks(tmp_path, seed, n=200, d=16, n_blocks=3):
    """Split a corpus row-robin into blocks like the reference's ranks."""
    passages = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    for b in range(n_blocks):
        rows = np.arange(b, n, n_blocks)
        write_embedding_block(str(tmp_path), b, passages[rows], rows.astype(np.int64))
    return passages


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_blocked_search_matches_jax_searcher(tmp_path, storage):
    passages = make_blocks(tmp_path, 12)
    queries = np.random.RandomState(13).randn(5, 16).astype(np.float32)
    ours = BlockedSearcher(
        SearchConfig(passage_block_size=64, storage_dtype=storage), device=CPU
    )
    ref = JaxSearcher(JaxSearchConfig(passage_block_size=64, storage_dtype=storage))
    s, offsets = ours.search_blocks(str(tmp_path), queries, 30)
    js, joffsets = ref.search_blocks(str(tmp_path), queries, 30)
    if storage == "float32":
        os_, oi = jes.topk_oracle(queries, passages, 30)
        np.testing.assert_array_equal(offsets, oi.astype(np.int64))
        np.testing.assert_array_equal(offsets, joffsets)
        np.testing.assert_allclose(s, os_, rtol=1e-5)
    else:
        for r in range(5):
            assert set(offsets[r]) == set(joffsets[r])
    # the JAX package reads the port's blocks and finds the same rows
    for (_b, emb, ids), b in zip(jax_iter_blocks(str(tmp_path)), range(3)):
        np.testing.assert_array_equal(emb, passages[b::3])


@pytest.mark.parametrize("max_blocks", [1, 2, None])
def test_search_blocks_max_blocks_matches_jax_searcher(tmp_path, max_blocks):
    """``max_blocks`` scans only the first blocks, as the JAX searcher's
    does: the same scores and offsets, those of the scanned rows only."""
    passages = make_blocks(tmp_path, 16)
    queries = np.random.RandomState(17).randn(4, 16).astype(np.float32)
    s, offsets = BlockedSearcher(SearchConfig(passage_block_size=64), device=CPU).search_blocks(
        str(tmp_path), queries, 20, max_blocks=max_blocks)
    js, joffsets = JaxSearcher(JaxSearchConfig(passage_block_size=64)).search_blocks(
        str(tmp_path), queries, 20, max_blocks=max_blocks)
    np.testing.assert_array_equal(offsets, joffsets)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    rows = np.sort(np.concatenate([np.arange(b, 200, 3) for b in range(max_blocks or 3)]))
    _, oi = jes.topk_oracle(queries, passages[rows], 20)
    np.testing.assert_array_equal(offsets, rows[oi])


@pytest.mark.parametrize("storage", [torch.float32, torch.int8])
def test_flat_ip_topk_precision_highest_is_the_default(storage):
    q, p = problem(18, q=4, n=300, d=16)
    if storage == torch.int8:
        from convdr_torch.ops.quant import Int8Quantizer

        quant = Int8Quantizer.fit(p)
        q, p = quant.quantize_queries(q)[0], quant.quantize_passages(p)
    default = port_topk(q, p, 12, block_rows=128)
    highest = port_topk(q, p, 12, block_rows=128, precision="highest")
    js, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), 12, block_rows=128,
                              precision="highest")
    for a, b in zip(default, highest):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(highest[1], np.asarray(ji))
    np.testing.assert_allclose(highest[0], np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_flat_ip_topk_other_precisions_are_not_ported(precision):
    """They raised once; now, on the CPU, "high" and "default" are full f32,
    as in the JAX package there: the same top-k as "highest" and as the
    JAX package's at that precision (tolerance 0 on the indices)."""
    q, p = problem(19, q=2, n=64, d=8)
    got = port_topk(q, p, 5, precision=precision)
    for a, b in zip(got, port_topk(q, p, 5)):
        np.testing.assert_array_equal(a, b)
    _js, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), 5, precision=precision)
    np.testing.assert_array_equal(got[1], np.asarray(ji))
    with pytest.raises(ValueError, match="precision"):
        port_topk(q, p, 5, precision="tf32")
    # int8 passages ignore it, as in the JAX package
    p_i8 = np.clip(np.round(p * 20), -127, 127).astype(np.int8)
    q_int = np.round(q * 20).astype(np.float32)
    np.testing.assert_array_equal(port_topk(q_int, p_i8, 5, precision=precision)[1],
                                  port_topk(q_int, p_i8, 5)[1])


def test_search_arrays_matches_jax():
    q, p = problem(14, q=4, n=700, d=16)
    emb2offset = np.arange(700, dtype=np.int64)[::-1].copy()
    s, off = BlockedSearcher(SearchConfig(passage_block_size=256), device=CPU).search_arrays(
        q, p, emb2offset, 40
    )
    js, joff = JaxSearcher(JaxSearchConfig(passage_block_size=256)).search_arrays(
        q, p, emb2offset, 40
    )
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(off, emb2offset[jes.topk_oracle(q, p, 40)[1]])


def test_oversized_block_splits_and_matches_single_shot():
    rng = np.random.RandomState(15)
    passages = rng.randn(3000, 16).astype(np.float32)
    passages[13] = passages[2555]  # cross-sub-block tie
    queries = rng.randn(4, 16).astype(np.float32)
    whole = BlockedSearcher(SearchConfig(passage_block_size=64), device=CPU)
    # 1024-row floor -> 3 sub-blocks at n=3000
    cap = BlockedSearcher(
        SearchConfig(passage_block_size=64, max_device_block_bytes=1), device=CPU
    )
    ws, wi = whole.search_block(queries, passages, 30)
    cs, ci = cap.search_block(queries, passages, 30)
    np.testing.assert_array_equal(wi, ci)
    np.testing.assert_array_equal(ws, cs)
    np.testing.assert_array_equal(wi, jes.topk_oracle(queries, passages, 30)[1])


def test_search_missing_dir_and_unported_options(tmp_path):
    import ml_dtypes

    with pytest.raises(FileNotFoundError):
        BlockedSearcher(device=CPU).search_blocks(str(tmp_path), np.zeros((1, 4), np.float32), 5)
    # bf16 block files (the JAX package writes them with ml_dtypes) raised
    # before they were ported; now they are written and searched, and rows
    # of another dtype are refused
    bf16_rows = np.arange(32, dtype=np.float32).reshape(8, 4).astype(ml_dtypes.bfloat16)
    _s, i = BlockedSearcher(device=CPU).search_block(np.ones((1, 4), np.float32), bf16_rows, 5)
    np.testing.assert_array_equal(i, [[7, 6, 5, 4, 3]])
    write_embedding_block(str(tmp_path), 0, bf16_rows, np.arange(8))
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        BlockedSearcher(device=CPU).search_block(
            np.zeros((1, 4), np.float32), np.zeros((8, 4), np.float16), 5)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        write_embedding_block(str(tmp_path), 1, np.zeros((8, 4), np.float16), np.arange(8))
    with pytest.raises(ValueError, match="storage_dtype"):
        BlockedSearcher(SearchConfig(storage_dtype="float16"), device=CPU)
