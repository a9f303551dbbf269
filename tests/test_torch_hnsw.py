"""The port's HNSW wrapper (convdr_torch/retrieval/hnsw.py) on the CPU.

The cases of the JAX package's ``tests/test_hnsw.py`` on the port's
``HnswIndex`` / ``DenseHNSWFlatIndexer`` (recall bounds as there), merged
into parametrised tests where they repeat each other, and the port against
the JAX package: at one build thread, on the same seeded rows, both build
the same graph, so neighbour ids and distances are equal bit for bit (the
same C++ source, compiled with the same flags).
"""

import ctypes
import os

import numpy as np
import pytest

from convdr_torch import native_io
from convdr_torch.retrieval.hnsw import DenseHNSWFlatIndexer, HnswIndex


def clustered(rng, n, d, n_centres, noise, spread=1.0):
    centres = rng.randn(n_centres, d).astype(np.float32) * spread
    return centres, centres[rng.randint(0, n_centres, size=n)] + noise * rng.randn(
        n, d).astype(np.float32)


def l2_recall(data, q, ids, k):
    full = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(full, axis=1)[:, :k]
    return np.mean([len(set(ids[r]) & set(exact[r])) / k for r in range(len(q))])


@pytest.mark.parametrize("case", ["gaussian_serial", "clustered_serial_then_4_threads"])
def test_hnsw_l2_recall(case):
    """L2 recall@10 > 0.9 against the exact L2 top-k, distances ascending:
    Gaussian rows built serially, and clustered rows built as a serial
    prefix then 4 concurrent threads (a schedule-dependent graph with the
    same recall contract)."""
    rng = np.random.RandomState(0)
    k = 10
    if case == "gaussian_serial":
        data = rng.randn(2000, 16).astype(np.float32)
        q = rng.randn(20, 16).astype(np.float32)
        idx = HnswIndex(16, m=16, ef_construction=100, ef_search=100)
        idx.add(data)
        dists, ids = idx.search(q, k)
    else:
        centres, data = clustered(rng, 3000, 24, 40, 1.0, spread=4.0)
        q = centres[rng.randint(0, 40, size=32)] + rng.randn(32, 24).astype(np.float32)
        idx = HnswIndex(24, m=16, ef_construction=100, ef_search=100)
        idx.add(data[:1000])
        idx.add(data[1000:], num_threads=4)
        dists, ids = idx.search(q, k, num_threads=4)
    assert len(idx) == len(data)
    recall = l2_recall(data, q, ids, k)
    assert recall > 0.9, recall
    assert np.all(np.diff(dists, axis=1) >= 0)


def test_hnsw_empty_index():
    idx = HnswIndex(8)
    _dists, ids = idx.search(np.random.RandomState(1).randn(2, 8).astype(np.float32), 3)
    assert np.all(ids == -1)


@pytest.mark.parametrize("case,bound", [("gaussian", 0.85), ("clustered", 0.95)])
def test_dense_hnsw_flat_indexer_ip_recall(case, bound):
    """The IP -> L2 auxiliary dimension: the documents returned are the
    exact maximum-inner-product ones (recall@k above the JAX test's bound).
    Clustered rows must reach ~full recall at a moderate ef: the graph's
    diversity selection keeps the bridges between clusters."""
    rng = np.random.RandomState(2)
    if case == "gaussian":
        n, d, k = 1500, 16, 5
        docs = rng.randn(n, d).astype(np.float32)
        q = rng.randn(10, d).astype(np.float32)
        indexer = DenseHNSWFlatIndexer(d, store_n=32, ef_search=128, ef_construction=100)
        data = [(f"doc{i}", docs[i]) for i in range(n)]
    else:
        n, d, k = 3000, 64, 10
        centres, docs = clustered(rng, n, d, 40, 0.35)
        q = centres[rng.randint(0, 40, size=16)] + 0.35 * rng.randn(16, d).astype(np.float32)
        indexer = DenseHNSWFlatIndexer(d, store_n=16, ef_construction=100, ef_search=64)
        data = [(f"doc{i}", docs[i]) for i in range(n)]
    indexer.index_data(data)
    oracle = np.argsort(-(q @ docs.T), axis=1)[:, :k]
    results = indexer.search_knn(q, k)
    recall = np.mean([
        len({int(x[3:]) for x in ids if x is not None} & set(oracle[r].tolist())) / k
        for r, (ids, _s) in enumerate(results)
    ])
    assert recall >= bound, recall


def test_dense_hnsw_rejects_second_index_data():
    rng = np.random.RandomState(3)
    indexer = DenseHNSWFlatIndexer(8, ef_construction=50)
    data = [(i, rng.randn(8).astype(np.float32)) for i in range(50)]
    indexer.index_data(data)
    with pytest.raises(RuntimeError):
        indexer.index_data(data)


@pytest.mark.parametrize("case", ["parallel_entry_one_thread", "search_threads"])
def test_hnsw_results_do_not_depend_on_threads(case):
    """The parallel insertion entry at one thread builds the serial graph
    (the same level draws, the same link order); and a search at 4
    threads returns what a serial search does. Both bit for bit."""
    rng = np.random.RandomState(4)
    data = rng.randn(1200, 16).astype(np.float32)
    q = rng.randn(64, 16).astype(np.float32)
    a = HnswIndex(16, m=16, ef_construction=80, ef_search=80, seed=3)
    a.add(data)
    if case == "parallel_entry_one_thread":
        b = HnswIndex(16, m=16, ef_construction=80, ef_search=80, seed=3)
        vecs = np.ascontiguousarray(data, np.float32)
        b._lib.convdr_hnsw_add_parallel(
            b._handle, vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vecs.shape[0], 1)
        (da, ia), (db, ib) = a.search(q, 10, num_threads=1), b.search(q, 10, num_threads=1)
    else:
        (da, ia), (db, ib) = a.search(q, 10, num_threads=1), a.search(q, 10, num_threads=4)
    assert np.array_equal(ia, ib)
    assert np.array_equal(da, db)


def test_set_ef_search_and_shape_check():
    """``set_ef_search`` reaches the graph (a wider beam finds at least
    what a beam of 1 finds), and rows of another width raise."""
    rng = np.random.RandomState(5)
    _c, data = clustered(rng, 1500, 16, 30, 0.5)
    q = data[:40] + 0.1 * rng.randn(40, 16).astype(np.float32)
    idx = HnswIndex(16, m=4, ef_construction=40, ef_search=1)
    idx.add(data)
    narrow = l2_recall(data, q, idx.search(q, 10)[1], 10)
    idx.set_ef_search(200)
    wide = l2_recall(data, q, idx.search(q, 10)[1], 10)
    assert wide >= narrow and wide > 0.95, (narrow, wide)
    with pytest.raises(ValueError):
        idx.add(np.zeros((3, 15), np.float32))
    with pytest.raises(ValueError):
        idx.search(np.zeros((3, 17), np.float32), 5)


def test_hnsw_library_built_with_the_makefile_flags():
    """The HNSW library is its own build, with the JAX package's Makefile
    flags, named by a hash of the source, the flags and the CPU."""
    assert "-march=native" in native_io.HNSW_CXX_FLAGS
    assert "-funroll-loops" in native_io.HNSW_CXX_FLAGS
    path = native_io.hnsw_library_path()
    native_io.load_hnsw()
    assert path.endswith(".so") and "libconvdr_hnsw-" in path and os.path.exists(path)


@pytest.mark.parametrize("kind", ["hnsw_index", "dense_indexer"])
def test_hnsw_equals_the_jax_package(kind):
    """One build thread, the same seeded rows: neighbour ids and distances
    equal to the JAX package's ``HnswIndex`` / ``DenseHNSWFlatIndexer``
    bit for bit (tolerance 0: the same graph)."""
    from convdr_tpu.native_io import native_available
    from convdr_tpu.retrieval import hnsw as jax_hnsw

    assert native_available()
    rng = np.random.RandomState(6)
    _c, data = clustered(rng, 2500, 32, 50, 0.5)
    q = data[rng.randint(0, 2500, 48)] + 0.3 * rng.randn(48, 32).astype(np.float32)
    if kind == "hnsw_index":
        ours = HnswIndex(32, m=16, ef_construction=100, ef_search=64, seed=7)
        theirs = jax_hnsw.HnswIndex(32, m=16, ef_construction=100, ef_search=64, seed=7)
        for idx in (ours, theirs):
            idx.add(data)
        d_o, i_o = ours.search(q, 10, num_threads=1)
        d_t, i_t = theirs.search(q, 10, num_threads=1)
        np.testing.assert_array_equal(i_o, i_t)
        np.testing.assert_array_equal(d_o, d_t)
    else:
        pairs = [(f"p{i}", data[i]) for i in range(len(data))]
        ours = DenseHNSWFlatIndexer(32, store_n=16, ef_construction=100, ef_search=64)
        theirs = jax_hnsw.DenseHNSWFlatIndexer(32, store_n=16, ef_construction=100,
                                               ef_search=64)
        ours.index_data(pairs)
        theirs.index_data(pairs)
        assert ours.phi == theirs.phi
        for (ids_o, s_o), (ids_t, s_t) in zip(ours.search_knn(q, 10), theirs.search_knn(q, 10)):
            assert ids_o == ids_t
            np.testing.assert_array_equal(np.asarray(s_o), np.asarray(s_t))
