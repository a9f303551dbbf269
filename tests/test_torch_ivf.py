"""convdr_torch's k-means and IVF index against the JAX package's (CPU).

Mirrors the single-device cases of ``tests/test_ivf.py``: the same seeded
inputs go through ``convdr_tpu.ops.kmeans`` / ``convdr_tpu.retrieval.ivf``
and the port's counterparts. Tolerances, stated per test:

  * k-means: the port scores in f32 where the JAX package rounds to bf16, so
    on separated data whose seeded fit meets no near-tie the built
    ``lists.npy`` and ``rowids.npy`` are byte-identical, and elsewhere the
    check is the contract (full probe == exact set, recall);
  * one index searched by both packages (cross-loaded either way): equal
    row ids, f32 scores within 1e-5 (another summation order), int8 scores
    exactly equal (integer arithmetic in both).
"""

import numpy as np
import pytest
import torch

from convdr_torch.ops import kmeans as tk
from convdr_torch.ops.exact_search import NEG_INF, topk_oracle
from convdr_torch.ops.quant import Int8Quantizer, int8_topk_oracle
from convdr_torch.parallel.dryrun import single_rank
from convdr_torch.parallel.mesh import get_mesh
from convdr_torch.retrieval import ivf as tivf
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_tpu.ops import kmeans as jk
from convdr_tpu.retrieval import ivf as jivf

CPU = torch.device("cpu")


def _clustered(n, d, n_clusters, seed=0, spread=0.05):
    rng = np.random.Generator(np.random.PCG64(seed))
    centers = rng.standard_normal((n_clusters, d), dtype=np.float32)
    which = rng.integers(0, n_clusters, size=n)
    x = centers[which] + spread * rng.standard_normal((n, d), dtype=np.float32)
    return x.astype(np.float32), centers, which


def _gauss(seed, *shape):
    return np.random.Generator(np.random.PCG64(seed)).standard_normal(shape, dtype=np.float32)


def _recall(got, want):
    return np.mean([len(set(got[r]) & set(want[r])) / want.shape[1] for r in range(len(want))])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
def test_kmeans_recovers_separated_clusters():
    x, centers, _ = _clustered(600, 16, 4, seed=1, spread=0.02)
    c = tk.fit_kmeans(x, 4, iters=25, seed=0, device=CPU)
    d2 = ((c[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assert sorted(d2.argmin(axis=1)) == [0, 1, 2, 3]
    assert np.all(d2.min(axis=1) < 0.01)


def test_kmeans_handles_degenerate_duplicates():
    x = np.repeat(np.eye(3, 8, dtype=np.float32), 40, axis=0)
    c = tk.fit_kmeans(x, 6, iters=5, seed=0, device=CPU)
    assert np.all(np.isfinite(c)) and c.shape == (6, 8)
    with pytest.raises(ValueError):
        tk.fit_kmeans(x, 0, device=CPU)


@pytest.mark.parametrize("counts", [[10, 0, 0], [1, 0, 0], [4, 7, 0, 3, 0]])
def test_split_empty_equals_jax(counts):
    counts = np.asarray(counts, np.float32)
    c = _gauss(3, counts.shape[0], 4)
    got_c, got_n = tk._split_empty(c, counts)
    want_c, want_n = jk._split_empty(c, counts)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_n == want_n


def test_assign_top_t_matches_numpy_and_jax():
    x = _gauss(7, 300, 12)
    c = _gauss(8, 20, 12)
    got = tk.assign_top_t(x, c, t=3, device=CPU)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1, kind="stable")[:, :3]
    # f32 scores: rows whose three nearest are apart by > 1e-3 agree fully
    part = np.sort(d2, axis=1)
    clear = np.all(np.diff(part[:, :4], axis=1) > 1e-3, axis=1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    # the JAX package assigns in bf16: its nearest agrees off near-ties
    clear1 = (part[:, 1] - part[:, 0]) > 1e-2
    np.testing.assert_array_equal(got[clear1, 0], jk.assign_top_t(x, c, t=3)[clear1, 0])
    assert got.shape == (300, 3) and got.dtype == np.int32


def test_assign_top_t_host_chunking_and_bf16_inputs(monkeypatch):
    import ml_dtypes

    x = _gauss(17, 1000, 16)
    c = _gauss(18, 12, 16)
    want = tk.assign_top_t(x, c, t=2, device=CPU)
    monkeypatch.setattr(tk, "_ASSIGN_CHUNK_BYTES", 4 * x.shape[1] * 800)
    np.testing.assert_array_equal(tk.assign_top_t(x, c, t=2, block_rows=100, device=CPU), want)
    xb = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        tk.assign_top_t(xb.view(np.uint16), c, t=2, device=CPU),
        tk.assign_top_t(xb, c, t=2, device=CPU),
    )


# ---------------------------------------------------------------------------
# layout and build
# ---------------------------------------------------------------------------
def test_sublist_layout_equals_jax():
    rng = np.random.Generator(np.random.PCG64(3))
    n, k, cap = 500, 8, 24
    weights = (np.arange(k, dtype=np.float64) + 1) ** 2  # heavy skew
    assign = rng.choice(k, size=n, p=weights / weights.sum()).astype(np.int32)
    got = tivf._sublist_layout(assign, k, cap)
    want = jivf._sublist_layout(assign, k, cap)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    sub_id, slot, owner, stats = got
    np.testing.assert_array_equal(owner[sub_id], assign)
    assert len(np.unique(sub_id.astype(np.int64) * cap + slot)) == n
    assert stats["pad_rows"] == stats["n_sublists"] * cap - n


@pytest.mark.parametrize(
    "n,d,n_clusters,nlist,seed,storage",
    [(1200, 16, 8, 4, 0, "float32"), (1200, 16, 8, 4, 1, "int8"),
     (1000, 16, 4, 2, 2, "bfloat16"), (1200, 16, 8, 8, 1, "float32")],
)
def test_built_lists_byte_identical_to_jax(n, d, n_clusters, nlist, seed, storage):
    """Separated clusters whose seeded fit meets no near-tie: the port's
    f32 k-means and the JAX package's bf16 one assign every row alike, so
    the saved list tensor and row ids are byte-identical."""
    x, _, _ = _clustered(n, d, n_clusters, seed=1, spread=0.02)
    a = IVFIndex.build(x, nlist, iters=25, seed=seed, storage_dtype=storage, device=CPU)
    b = jivf.IVFIndex.build(x, nlist, iters=25, seed=seed, storage_dtype=storage)
    assert a.lists.dtype == b.lists.dtype
    assert a.lists.tobytes() == b.lists.tobytes()
    assert a.rowids.tobytes() == b.rowids.tobytes()
    assert a.stats == b.stats


def test_full_probe_matches_flat_oracle():
    x = _gauss(11, 2000, 24)
    q = _gauss(12, 16, 24)
    idx = IVFIndex.build(x, 16, iters=8, seed=0, device=CPU)
    s, i = idx.search(q, 10, nprobe=idx.nlist)
    o_s, o_i = topk_oracle(q, x, 10)
    for row in range(q.shape[0]):
        assert set(i[row]) == set(o_i[row])
    np.testing.assert_allclose(np.sort(s, 1), np.sort(o_s, 1), rtol=1e-5)


def test_recall_on_clustered_corpus():
    x, _, _ = _clustered(4000, 32, 64, seed=5, spread=0.05)
    rng = np.random.Generator(np.random.PCG64(9))
    q = x[rng.choice(4000, 32, replace=False)] + 0.01 * rng.standard_normal(
        (32, 32), dtype=np.float32
    )
    idx = IVFIndex.build(x, 32, iters=15, seed=0, device=CPU)
    _, o_i = topk_oracle(q, x, 10)
    recall4 = _recall(idx.search(q, 10, nprobe=4)[1], o_i)
    recall16 = _recall(idx.search(q, 10, nprobe=16)[1], o_i)
    assert recall4 >= 0.75, recall4
    assert recall16 >= 0.95 and recall16 >= recall4, recall16


def test_int8_full_probe_matches_int8_oracle_exactly():
    x = _gauss(13, 1500, 16)
    q = _gauss(14, 8, 16)
    idx = IVFIndex.build(x, 12, storage_dtype="int8", iters=8, seed=0, device=CPU)
    s, i = idx.search(q, 10, nprobe=idx.nlist)
    q_int, tq = idx.quantizer.quantize_queries(q)
    p_i8 = idx.quantizer.quantize_passages(x)
    o_s, o_i = int8_topk_oracle(q_int, p_i8, 10)
    int_scores = q_int.astype(np.int64) @ p_i8.astype(np.int64).T
    for row in range(q.shape[0]):
        # probe-major order breaks integer ties otherwise: only rows tied
        # with the 10th score may differ
        for r in set(i[row]) ^ set(o_i[row]):
            assert int_scores[row, r] == o_s[row, -1]
    # integer scores, exact: the same f32 product of the oracle's integers
    np.testing.assert_array_equal(np.sort(s, 1), np.sort((o_s * tq).astype(np.float32), 1))


def test_custom_rowids_returned():
    x = _gauss(17, 400, 8)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    payload = np.arange(400, dtype=np.int32) * 7 + 3
    idx = IVFIndex.build(x, 4, rowids=payload, iters=5, seed=0, device=CPU)
    _, i = idx.search(x[:5], 1, nprobe=idx.nlist)
    np.testing.assert_array_equal(i[:, 0], payload[:5])


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "pq4"])
def test_query_chunking_is_transparent(storage):
    x = _gauss(19, 800, 16)
    q = _gauss(20, 9, 16)
    idx = IVFIndex.build(x, 8, iters=5, seed=0, storage_dtype=storage, pq_m=8, device=CPU)
    s1, i1 = idx.search(q, 5, nprobe=3)
    s2, i2 = idx.search(q, 5, nprobe=3, max_candidate_bytes=1)  # one query a chunk
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


@pytest.mark.parametrize("storage,work", [("float32", 4), ("bfloat16", 2 + 4), ("int8", 1 + 4)])
def test_candidate_transient_stays_under_the_budget(monkeypatch, storage, work):
    """What one scoring step holds, the gathered candidates plus their f32
    working copy (``work`` bytes an element: the storage item, and 4 more
    where bf16 or int8 rows are converted), stays under
    ``max_candidate_bytes`` also where one query's candidates exceed it:
    the probed sub-lists are then scored a group at a time. Results equal
    the search under the default budget (ids exactly, scores to 1e-6)."""
    x = _gauss(25, 800, 16)
    q = _gauss(26, 5, 16)
    idx = IVFIndex.build(x, 8, iters=5, seed=0, storage_dtype=storage, device=CPU)
    want = idx.search(q, 10, nprobe=idx.nlist)
    budget = idx.nlist * idx.cap * 16 * work // 3  # a third of one query's candidates
    steps = []
    real_bmm = torch.bmm

    def bmm(cand, query):
        steps.append(cand.numel() * work)  # cand is the f32 working copy
        return real_bmm(cand, query)

    monkeypatch.setattr(torch, "bmm", bmm)
    got = idx.search(q, 10, nprobe=idx.nlist, max_candidate_bytes=budget)
    assert max(steps) <= budget and len(steps) >= 3 * len(q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_adc_query_chunking_is_transparent(monkeypatch):
    x = _gauss(21, 600, 16)
    q = _gauss(22, 7, 16)
    idx = IVFIndex.build(x, 6, iters=5, seed=0, storage_dtype="pq8", pq_m=4, device=CPU)
    want = idx.search(q, 8, nprobe=3, exact=True)
    monkeypatch.setattr(tivf, "_ADC_CHUNK_BYTES", 1)  # one query an ADC chunk
    got = idx.search(q, 8, nprobe=3, exact=True)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_adc_transient_stays_under_its_budget(monkeypatch):
    """A full probe's per-query ADC transient (a gathered f32 LUT entry and
    its int64 index for every candidate code) stays under
    ``_ADC_CHUNK_BYTES`` where one query's candidates exceed it: the
    sub-lists are scored a group at a time. Results equal the search under
    the default budget, bit for bit (f32 LUT)."""
    x = _gauss(27, 600, 16)
    q = _gauss(28, 4, 16)
    idx = IVFIndex.build(x, 6, iters=5, seed=0, storage_dtype="pq8", pq_m=4, device=CPU)
    want = idx.search(q, 8, nprobe=idx.nlist, exact=True)
    budget = idx.nlist * idx.cap * 4 * tivf._ADC_ELEMENT_BYTES // 3
    monkeypatch.setattr(tivf, "_ADC_CHUNK_BYTES", budget)
    steps = []
    real_gather = torch.gather

    def gather(src, dim, index):
        steps.append(index.numel() * tivf._ADC_ELEMENT_BYTES)
        return real_gather(src, dim, index)

    monkeypatch.setattr(torch, "gather", gather)
    got = idx.search(q, 8, nprobe=idx.nlist, exact=True)
    assert max(steps) <= budget and len(steps) >= 3 * len(q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("storage", ["float32", "int8", "bfloat16"])
def test_save_load_roundtrip(tmp_path, storage):
    x = _gauss(23, 600, 16)
    q = _gauss(24, 4, 16)
    idx = IVFIndex.build(x, 8, storage_dtype=storage, iters=5, seed=0, device=CPU)
    if storage == "bfloat16":
        assert idx.lists.dtype == np.uint16  # bf16 bit patterns on the host
    s1, i1 = idx.search(q, 7, nprobe=idx.nlist)
    idx.save(str(tmp_path / storage))
    idx2 = IVFIndex.load(str(tmp_path / storage), device=CPU)
    assert idx2.storage_dtype == storage and idx2.ntotal == 600
    s2, i2 = idx2.search(q, 7, nprobe=idx2.nlist)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)


def test_bfloat16_full_probe_recall():
    x = _gauss(31, 800, 16)
    q = _gauss(32, 6, 16)
    idx = IVFIndex.build(x, 8, storage_dtype="bfloat16", iters=5, seed=0, device=CPU)
    _, i = idx.search(q, 10, nprobe=idx.nlist)
    # bf16-rounded rows: the f32 oracle's sets except bf16 near-ties
    assert _recall(i, topk_oracle(q, x, 10)[1]) >= 0.9


def test_k_exceeding_candidates_pads():
    x = _gauss(29, 100, 8)
    idx = IVFIndex.build(x, 10, iters=4, seed=0, device=CPU)
    s, i = idx.search(x[:3], 50, nprobe=1)
    assert s.shape == (3, 50)
    assert np.all(i[s == NEG_INF] == -1) and (s == NEG_INF).any()
    valid = i[0][i[0] >= 0]
    assert len(valid) == len(set(valid.tolist()))


def test_build_from_blocks_matches_payload(tmp_path):
    x = _gauss(37, 600, 16)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    offsets = np.arange(600, dtype=np.int64) * 3 + 11
    d = str(tmp_path / "blocks")
    for b in range(2):
        write_embedding_block(d, b, x[b::2], offsets[b::2])
    idx = IVFIndex.build_from_blocks(d, 8, iters=6, seed=0, device=CPU)
    assert idx.ntotal == 600
    _, i = idx.search(x[:5], 1, nprobe=idx.nlist)
    np.testing.assert_array_equal(i[:, 0], offsets[:5].astype(np.int32))


def test_build_from_blocks_int8_blocks(tmp_path):
    x = _gauss(41, 400, 16)
    quant = Int8Quantizer.fit(x)
    d = str(tmp_path / "blocks_i8")
    for b in range(2):
        write_embedding_block(d, b, quant.quantize_passages(x[b::2]),
                              np.arange(400, dtype=np.int64)[b::2])
    quant.save(d)
    with pytest.raises(ValueError):
        IVFIndex.build_from_blocks(d, 4, storage_dtype="float32", device=CPU)
    idx = IVFIndex.build_from_blocks(d, 4, storage_dtype="int8", iters=5, seed=0, device=CPU)
    assert idx.storage_dtype == "int8" and idx.ntotal == 400
    q = _gauss(42, 4, 16)
    _, i = idx.search(q, 10, nprobe=idx.nlist)
    o_s, o_i = int8_topk_oracle(quant.quantize_queries(q)[0], quant.quantize_passages(x), 10)
    for r in range(4):
        assert set(i[r]) == set(o_i[r])


def test_rejects_bad_shapes_and_non_mesh_and_world1_mesh_equals_unmeshed():
    with pytest.raises(ValueError):
        IVFIndex(np.zeros((4, 8), np.float32), np.zeros((4, 10, 8), np.float32),
                 np.zeros((4, 9), np.int32))
    with pytest.raises(ValueError):
        IVFIndex(np.zeros((4, 8), np.float32), np.zeros((4, 10, 8), np.int8),
                 np.zeros((4, 10), np.int32))
    idx = IVFIndex(np.zeros((4, 8), np.float32), np.zeros((4, 10, 8), np.float32),
                   np.zeros((4, 10), np.int32), device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        idx.search(np.zeros((1, 8), np.float32), 3, mesh=object())
    x, q = _gauss(43, 500, 16), _gauss(44, 5, 16)
    for storage in ("float32", "int8"):
        built = IVFIndex.build(x, 6, storage_dtype=storage, iters=4, seed=0, device=CPU)
        want = built.search(q, 10, nprobe=2)
        with single_rank():
            got = built.search(q, 10, nprobe=2, mesh=get_mesh(("index",)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_capacity_guard_message_equals_jax():
    x = np.zeros((64, 8), np.float32)
    idx = IVFIndex.build(x, 4, iters=2, seed=0, device=CPU)
    ref = jivf.IVFIndex(idx.centroids, idx.lists, idx.rowids)
    idx.max_resident_bytes = ref.max_resident_bytes = 64
    assert IVFIndex.max_resident_bytes == jivf.IVFIndex.max_resident_bytes == 12 << 30
    with pytest.raises(MemoryError, match="GB resident per device") as got:
        idx.search(x[:2], 3)
    with pytest.raises(MemoryError) as want:
        ref.search(x[:2], 3)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# rescoring
# ---------------------------------------------------------------------------
def test_rescore_block_pass_recovers_oracle_ranking(tmp_path):
    x, _c, _w = _clustered(1200, 32, 24, seed=11, spread=0.08)
    offsets = np.arange(1200, dtype=np.int64) * 2 + 5
    d = str(tmp_path / "blocks")
    for b in range(3):
        write_embedding_block(d, b, x[b::3], offsets[b::3])
    idx = IVFIndex.build_from_blocks(d, 8, storage_dtype="pq4", pq_m=8, iters=6, seed=0,
                                     device=CPU)
    rng = np.random.Generator(np.random.PCG64(12))
    q = x[rng.choice(1200, 8, replace=False)] + 0.02 * rng.standard_normal(
        (8, 32), dtype=np.float32
    )
    k, factor = 10, 4
    _s, cand = idx.search(q, factor * k, nprobe=idx.nlist)
    s, i = idx.rescore_block_pass(d, q, cand, k)
    off_to_row = {int(o): r for r, o in enumerate(offsets)}
    for r in range(8):
        rows = np.array(sorted(off_to_row[int(c)] for c in cand[r] if c >= 0))
        true = q[r] @ x[rows].T
        order = np.argsort(-true, kind="stable")[:k]
        np.testing.assert_allclose(s[r], true[order], rtol=1e-5)
        np.testing.assert_array_equal(i[r], offsets[rows[order]].astype(np.int32))
    # the JAX package's streaming pass over the same candidates: bit-equal
    js, ji = jivf.IVFIndex.rescore_block_pass(idx, d, q, cand, k)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(i, ji)
    _, o_i = topk_oracle(q, x, k)
    oracle = offsets[o_i]
    assert _recall(i, oracle) >= _recall(idx.search(q, k, nprobe=idx.nlist)[1], oracle) - 1e-9


def test_rescore_block_pass_multichunk_duplicates(tmp_path):
    x = _gauss(21, 60, 8)
    offsets = np.repeat(np.arange(30, dtype=np.int64), 2)  # 2 chunks a doc
    d = str(tmp_path / "blocks_mc")
    write_embedding_block(d, 0, x, offsets)
    idx = IVFIndex.build(x, 4, rowids=offsets.astype(np.int32), iters=5, seed=0, device=CPU)
    q = _gauss(22, 3, 8)
    _s, cand = idx.search(q, 40, nprobe=idx.nlist)
    s, i = idx.rescore_block_pass(d, q, cand, 5)
    true = q @ x.T
    chunk_max = np.maximum(true[:, 0::2], true[:, 1::2])
    for r in range(3):
        np.testing.assert_allclose(s[r], chunk_max[r, i[r]], rtol=1e-5)
        _, first = np.unique(i[r], return_index=True)
        docs = i[r][np.sort(first)]
        np.testing.assert_array_equal(docs, np.argsort(-chunk_max[r], kind="stable")[: len(docs)])


def test_rescore_block_pass_int8_blocks(tmp_path):
    x = _gauss(31, 300, 16)
    quant = Int8Quantizer.fit(x)
    d = str(tmp_path / "blocks_i8r")
    write_embedding_block(d, 0, quant.quantize_passages(x), np.arange(300, dtype=np.int64))
    quant.save(d)
    idx = IVFIndex.build_from_blocks(d, 4, storage_dtype="pq4", pq_m=8, iters=5, seed=0,
                                     device=CPU)
    q = _gauss(32, 4, 16)
    _s, cand = idx.search(q, 30, nprobe=idx.nlist)
    s, _i = idx.rescore_block_pass(d, q, cand, 5)
    deq = quant.quantize_passages(x).astype(np.float32) * quant.scales
    for r in range(4):
        rows = np.array(sorted(int(c) for c in cand[r] if c >= 0))
        true = q[r] @ deq[rows].T
        np.testing.assert_allclose(s[r], true[np.argsort(-true, kind="stable")[:5]], rtol=1e-5)


def test_rescore_block_pass_wrong_dir_raises(tmp_path):
    x = _gauss(51, 100, 8)
    d = str(tmp_path / "blocks_a")
    write_embedding_block(d, 0, x, np.arange(100, dtype=np.int64))
    idx = IVFIndex.build(x, 4, rowids=np.arange(100, dtype=np.int32) + 5000, iters=4, seed=0,
                         device=CPU)
    q = _gauss(52, 2, 8)
    _s, cand = idx.search(q, 10, nprobe=idx.nlist)
    with pytest.raises(ValueError, match="never appeared"):
        idx.rescore_block_pass(d, q, cand, 5)
    with pytest.raises(FileNotFoundError):
        idx.rescore_block_pass(str(tmp_path / "empty"), q, cand, 5)


# ---------------------------------------------------------------------------
# IVFPQ from a flat PQ index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pack", [False, True])
def test_from_pq_index_reuses_codes_exactly(tmp_path, pack):
    x = _gauss(77, 600, 16)
    offsets = np.arange(600, dtype=np.int64) * 3 + 11
    d = str(tmp_path / "blocks")
    for b in range(2):
        write_embedding_block(d, b, x[b::2], offsets[b::2])
    q = _gauss(78, 5, 16)
    flat = PQIndex.build_from_blocks(d, 8, 4, iters=6, seed=1, pack=pack, device=CPU)
    ivf = IVFIndex.from_pq_index(flat, d, 8, iters=6, seed=0)
    assert ivf.storage_dtype == "pq4" and ivf.packed is pack and ivf.ntotal == flat.ntotal
    # code rows moved, never re-encoded
    live = ivf.rowids.reshape(-1) >= 0
    assert {bytes(r) for r in ivf.lists.reshape(-1, ivf.lists.shape[2])[live]} == {
        bytes(r) for r in flat.codes
    }
    order = np.argsort(ivf.rowids.reshape(-1)[live])
    by_id = ivf.lists.reshape(-1, ivf.lists.shape[2])[live][order]
    np.testing.assert_array_equal(by_id, flat.codes[np.argsort(flat.rowids)])
    f_s, f_i = flat.search(q, 10, exact=True)
    i_s, i_i = ivf.search(q, 10, nprobe=ivf.nlist, exact=True)
    for row in range(q.shape[0]):
        assert set(i_i[row].tolist()) == set(f_i[row].tolist())
    np.testing.assert_allclose(np.sort(i_s, 1), np.sort(f_s, 1), rtol=1e-5, atol=1e-5)


def test_from_pq_index_bf16_blocks(tmp_path):
    import ml_dtypes

    x = _gauss(79, 400, 16).astype(ml_dtypes.bfloat16)
    d = str(tmp_path / "blocks")
    write_embedding_block(d, 0, x, np.arange(400, dtype=np.int64))
    flat = PQIndex.build_from_blocks(d, 8, 4, iters=5, seed=1, pack=True, device=CPU)
    ivf = IVFIndex.from_pq_index(flat, d, 8, iters=5, seed=0, train_sample=256)
    assert ivf.ntotal == 400 and ivf.packed
    q = _gauss(80, 4, 16)
    _, f_i = flat.search(q, 10, exact=True)
    _, i_i = ivf.search(q, 10, nprobe=ivf.nlist, exact=True)
    for row in range(4):
        assert set(i_i[row].tolist()) == set(f_i[row].tolist())


def test_from_pq_index_rejects_mismatched_blocks(tmp_path):
    x = _gauss(78, 200, 16)
    d_good = str(tmp_path / "good")
    write_embedding_block(d_good, 0, x, np.arange(200, dtype=np.int64))
    flat = PQIndex.build_from_blocks(d_good, 8, 4, iters=4, seed=1, device=CPU)
    d_bad = str(tmp_path / "bad")
    write_embedding_block(d_bad, 0, x, np.arange(200, dtype=np.int64) + 7)
    with pytest.raises(ValueError, match="do not match the PQIndex"):
        IVFIndex.from_pq_index(flat, d_bad, 8, iters=4, seed=0)
    d_short = str(tmp_path / "short")
    write_embedding_block(d_short, 0, x[:100], np.arange(100, dtype=np.int64))
    with pytest.raises(ValueError, match="do not match the PQIndex"):
        IVFIndex.from_pq_index(flat, d_short, 8, iters=4, seed=0)


# ---------------------------------------------------------------------------
# one index directory, both packages
# ---------------------------------------------------------------------------
_CROSS = [("float32", False), ("bfloat16", False), ("int8", False), ("pq4", False),
          ("pq4", True), ("pq8", False)]


@pytest.fixture(scope="module")
def cross_problem():
    x, _, _ = _clustered(1500, 32, 24, seed=61, spread=0.3)
    q = x[:12] + 0.1 * _gauss(62, 12, 32)
    return x, q


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("storage,pack", _CROSS)
def test_index_dir_cross_loads(tmp_path, cross_problem, writer, storage, pack):
    """An index saved by either package loads in the other and searches to
    the same results: equal ids, f32 scores within 1e-5, int8 scores exact."""
    x, q = cross_problem
    kw = dict(storage_dtype=storage, iters=6, seed=0, pq_m=8, pack=pack)
    d = str(tmp_path / "index")
    if writer == "jax":
        jivf.IVFIndex.build(x, 16, **kw).save(d)
    else:
        IVFIndex.build(x, 16, device=CPU, **kw).save(d)
    ours = IVFIndex.load(d, device=CPU)
    theirs = jivf.IVFIndex.load(d)
    for nprobe in (3, ours.nlist):
        s_t, i_t = ours.search(q, 10, nprobe=nprobe)
        s_j, i_j = theirs.search(q, 10, nprobe=nprobe)
        np.testing.assert_array_equal(i_t, i_j)
        if storage == "int8":
            np.testing.assert_array_equal(s_t, s_j)
        else:
            np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-5)
