"""convdr_torch's refine store against the JAX package's (CPU).

Mirrors ``tests/test_refine.py``: :class:`RefineStore` gathers only the
candidate rows (``.cnb`` blocks and reference-format pickle blocks through
the located payload offset) and its results are bit-identical, scores and
ids, to the streaming passes of both packages (``IVFIndex`` by value,
``PQIndex`` by position) and to the JAX package's store. Tolerance: none,
every comparison is exact.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from convdr_torch.ops.quant import Int8Quantizer
from convdr_torch.retrieval import refine as trf
from convdr_torch.retrieval.blocks import EMB_PREFIX, _block_path, write_embedding_block
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_torch.retrieval.refine import RefineStore, locate_pickle_payload
from convdr_tpu.retrieval import refine as jrf
from convdr_tpu.retrieval.ivf import IVFIndex as JaxIVFIndex
from convdr_tpu.retrieval.pq_index import PQIndex as JaxPQIndex

CPU = torch.device("cpu")


def _rng(seed=0):
    return np.random.Generator(np.random.PCG64(seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_locate_pickle_payload_all_dtypes(tmp_path, dtype):
    x = _rng(7).standard_normal((137, 24), dtype=np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    elif dtype == "int8":
        x = (x * 10).astype(np.int8)
    d = str(tmp_path / "blocks")
    write_embedding_block(d, 0, x, np.arange(137, dtype=np.int64))
    path = _block_path(d, EMB_PREFIX, 0)
    off, found = locate_pickle_payload(path, 137, 24)
    assert (off, found) == jrf.locate_pickle_payload(path, 137, 24)
    assert found == x.dtype
    mm = np.memmap(path, dtype=x.dtype, mode="r", offset=off, shape=x.shape)
    np.testing.assert_array_equal(np.asarray(mm), x)


def test_locate_pickle_payload_tiny_block_and_rejects(tmp_path):
    x = _rng(1).standard_normal((4, 8), dtype=np.float32).astype(np.int8)
    d = str(tmp_path / "tiny")
    write_embedding_block(d, 0, x, np.arange(4, dtype=np.int64))
    off, dt = locate_pickle_payload(_block_path(d, EMB_PREFIX, 0), 4, 8)
    assert dt == np.int8
    mm = np.memmap(_block_path(d, EMB_PREFIX, 0), dtype=np.int8, mode="r", offset=off,
                   shape=(4, 8))
    np.testing.assert_array_equal(np.asarray(mm), x)
    junk = str(tmp_path / "junk.pb")
    with open(junk, "wb") as f:
        f.write(os.urandom(4096))
    with pytest.raises(ValueError, match="no contiguous numpy payload"):
        locate_pickle_payload(junk, 17, 24)
    big = tmp_path / "x.pb"
    big.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):  # a > 4 GiB probe skips the u32 prefix
        locate_pickle_payload(str(big), 1 << 29, 768)


def _blocks_with_duplicates(tmp_path, dtype, fmt, n=240, dim=16, seed=5):
    """3 block files; offsets are doc ids, every 3rd doc has two chunk rows
    (multi-chunk FirstP), rows shuffled across blocks."""
    rng = _rng(seed)
    docs = np.arange(n // 2, dtype=np.int64) * 2 + 11
    offsets = np.concatenate([docs, docs[::3]])
    rng.shuffle(offsets)
    x = rng.standard_normal((offsets.shape[0], dim), dtype=np.float32)
    d = str(tmp_path / f"blk_{dtype}_{fmt}")
    quant = None
    if dtype == "int8":
        quant = Int8Quantizer.fit(x)
        stored = quant.quantize_passages(x)
    elif dtype == "bfloat16":
        stored = x.astype(ml_dtypes.bfloat16)
    else:
        stored = x
    for b in range(3):
        write_embedding_block(d, b, stored[b::3], offsets[b::3], fmt=fmt)
    if quant is not None:
        quant.save(d)
    return d, x, offsets


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_refine_by_value_bit_identical_to_streaming(tmp_path, dtype, fmt):
    d, x, offsets = _blocks_with_duplicates(tmp_path, dtype, fmt)
    dim = x.shape[1]
    idx = IVFIndex.build(x, 4, rowids=offsets.astype(np.int32), iters=4, seed=0, device=CPU)
    q = _rng(9).standard_normal((6, dim), dtype=np.float32)
    _s, cand = idx.search(q, 50, nprobe=idx.nlist)
    s_stream, i_stream = idx.rescore_block_pass(d, q, cand, 10)
    store = RefineStore.open(d, dim)
    s_ref, i_ref = store.refine_by_value(q, cand, 10)
    np.testing.assert_array_equal(s_ref, s_stream)
    np.testing.assert_array_equal(i_ref, i_stream)
    s_m, i_m = idx.rescore(d, q, cand, 10)
    np.testing.assert_array_equal(s_m, s_stream)
    np.testing.assert_array_equal(i_m, i_stream)
    # the JAX package's store and streaming pass over the same candidates
    js, ji = jrf.RefineStore.open(d, dim).refine_by_value(q, cand, 10)
    np.testing.assert_array_equal(s_ref, js)
    np.testing.assert_array_equal(i_ref, ji)
    js, ji = JaxIVFIndex.rescore_block_pass(idx, d, q, cand, 10)
    np.testing.assert_array_equal(s_stream, js)
    np.testing.assert_array_equal(i_stream, ji)


def test_refine_by_value_missing_rowid_raises(tmp_path):
    d, x, offsets = _blocks_with_duplicates(tmp_path, "float32", "pickle")
    store = RefineStore.open(d, x.shape[1])
    q = _rng(2).standard_normal((2, x.shape[1]), dtype=np.float32)
    cand = np.array([[offsets[0], 999999], [offsets[1], -1]], np.int64)
    with pytest.raises(ValueError, match="never appeared"):
        store.refine_by_value(q, cand, 2)
    with pytest.raises(FileNotFoundError):
        RefineStore.open(str(tmp_path / "nothing"), x.shape[1])


@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_refine_positional_bit_identical_to_streaming(tmp_path, fmt):
    rng = _rng(13)
    x = rng.standard_normal((360, 16), dtype=np.float32)
    offsets = np.arange(360, dtype=np.int64) * 3 + 7
    d = str(tmp_path / f"pqblk_{fmt}")
    for b in range(3):
        write_embedding_block(d, b, x[b::3], offsets[b::3], fmt=fmt)
    idx = PQIndex.build_from_blocks(d, m=8, nbits=4, iters=5, seed=0, device=CPU)
    q = rng.standard_normal((5, 16), dtype=np.float32)
    _, pos = idx.adc_topk(q, 40)
    s_stream, i_stream = idx.rescore_block_pass(d, q, pos, 10)
    store = RefineStore.open(d, 16)
    s_ref, p_ref = store.refine_positional(q, pos, 10, block_sizes=idx.stats["block_sizes"])
    np.testing.assert_array_equal(s_ref, s_stream)
    ids = np.where(p_ref >= 0, idx.rowids[np.clip(p_ref, 0, None)], -1)
    np.testing.assert_array_equal(ids.astype(np.int32), i_stream)
    s_m, i_m = idx.rescore(d, q, pos, 10)
    np.testing.assert_array_equal(s_m, s_stream)
    np.testing.assert_array_equal(i_m, i_stream)
    js, jp = jrf.RefineStore.open(d, 16).refine_positional(q, pos, 10)
    np.testing.assert_array_equal(s_ref, js)
    np.testing.assert_array_equal(p_ref, jp)
    js, ji = JaxPQIndex.rescore_block_pass(idx, d, q, pos, 10)
    np.testing.assert_array_equal(s_stream, js)
    np.testing.assert_array_equal(i_stream, ji)


def test_refine_positional_layout_mismatch_raises(tmp_path):
    x = _rng(17).standard_normal((60, 8), dtype=np.float32)
    d = str(tmp_path / "layout")
    write_embedding_block(d, 0, x, np.arange(60, dtype=np.int64))
    store = RefineStore.open(d, 8)
    q = _rng(18).standard_normal((1, 8), dtype=np.float32)
    with pytest.raises(ValueError, match="do not match"):
        store.refine_positional(q, np.array([[0, 1]], np.int64), 2, block_sizes=[30, 30])
    with pytest.raises(IndexError):
        store.gather_by_position(np.array([60]))


def test_refine_int8_positional_dequantizes(tmp_path):
    rng = _rng(23)
    x = rng.standard_normal((90, 8), dtype=np.float32)
    quant = Int8Quantizer.fit(x)
    d = str(tmp_path / "i8pos")
    write_embedding_block(d, 0, quant.quantize_passages(x), np.arange(90, dtype=np.int64))
    quant.save(d)
    store = RefineStore.open(d, 8)
    q = rng.standard_normal((2, 8), dtype=np.float32)
    pos = np.tile(np.arange(20, dtype=np.int64), (2, 1))
    s, p = store.refine_positional(q, pos, 5)
    deq = quant.quantize_passages(x).astype(np.float32) * quant.scales
    ws, wp = trf.rank_candidate_tail(np.einsum("cd,qd->qc", deq[:20], q).astype(np.float32),
                                     pos, 5)
    np.testing.assert_array_equal(s, ws)
    np.testing.assert_array_equal(p, wp)


def test_rank_candidate_tail_equals_jax():
    rng = _rng(29)
    scores = np.round(rng.standard_normal((4, 30)), 1).astype(np.float32)  # many ties
    ids = rng.integers(-1, 50, size=(4, 30))
    for k in (5, 30, 40):
        got = trf.rank_candidate_tail(scores, ids, k)
        want = jrf.rank_candidate_tail(scores, ids, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_refine_store_cache_keeps_only_format_misses(tmp_path, monkeypatch):
    """A directory with no random-access format (ValueError) is cached as
    None; an OSError is not cached, so the next call opens the store."""
    d, x, offsets = _blocks_with_duplicates(tmp_path, "float32", "pickle")
    idx = IVFIndex.build(x, 4, rowids=offsets.astype(np.int32), iters=4, seed=0, device=CPU)
    real_open = RefineStore.open
    calls = []

    def failing_open(*a, **kw):
        calls.append(1)
        raise OSError("transient read failure")

    monkeypatch.setattr(RefineStore, "open", failing_open)
    assert trf.cached_refine_store(idx, d, None) is None
    monkeypatch.setattr(RefineStore, "open", real_open)
    store = trf.cached_refine_store(idx, d, None)
    assert isinstance(store, RefineStore) and len(calls) == 1
    assert trf.cached_refine_store(idx, d, None) is store

    def format_miss(*a, **kw):
        calls.append(1)
        raise ValueError("not a pickle block")

    other = str(tmp_path / "other")
    monkeypatch.setattr(RefineStore, "open", format_miss)
    assert trf.cached_refine_store(idx, other, None) is None
    assert trf.cached_refine_store(idx, other, None) is None
    assert len(calls) == 2  # the second call hit the cache
