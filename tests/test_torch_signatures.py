"""Calls that are valid against the JAX package's public search classes run
in the port with the same keywords and give the JAX package's results (CPU).

``BlockedSearcher(config)`` takes no device (None means the card, a raise
without one) and accepts ``mesh=None`` / ``index_axis``;
``IVFIndex.search`` and ``PQIndex.search`` accept ``index_axis``. A mesh is
not ported and raises. Tolerances: equal row ids, f32 scores within 1e-5
(another summation order).
"""

import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.ops import pq as jpq
from convdr_tpu.retrieval import ivf as jivf
from convdr_tpu.retrieval.pq_index import PQIndex as JaxPQIndex
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxBlockedSearcher


def _gauss(seed, *shape):
    return np.random.Generator(np.random.PCG64(seed)).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("kwargs", [{}, {"mesh": None, "index_axis": "index"}])
def test_blocked_searcher_takes_the_jax_keywords(kwargs):
    q, p = _gauss(0, 6, 16), _gauss(1, 300, 16)
    offsets = np.arange(300, dtype=np.int64) * 3
    want_s, want_o = JaxBlockedSearcher(JaxSearchConfig(), **kwargs).search_arrays(q, p, offsets, 10)
    got_s, got_o = BlockedSearcher(tcfg.SearchConfig(), device="cpu", **kwargs).search_arrays(
        q, p, offsets, 10)
    np.testing.assert_array_equal(got_o, want_o)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_blocked_searcher_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        BlockedSearcher(tcfg.SearchConfig())
    assert BlockedSearcher(tcfg.SearchConfig(), device="cpu").device == torch.device("cpu")


def test_blocked_searcher_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BlockedSearcher(tcfg.SearchConfig(), device="cpu", mesh=object())


def test_ivf_search_takes_index_axis(tmp_path):
    x, q = _gauss(2, 1200, 16), _gauss(3, 8, 16)
    IVFIndex.build(x, 8, iters=8, seed=0, device="cpu").save(str(tmp_path))
    ours, theirs = IVFIndex.load(str(tmp_path), device="cpu"), jivf.IVFIndex.load(str(tmp_path))
    got_s, got_i = ours.search(q, 10, nprobe=3, index_axis="index")
    want_s, want_i = theirs.search(q, 10, nprobe=3, index_axis="index")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_pq_search_takes_index_axis():
    x = _gauss(4, 800, 32)
    index = PQIndex.build(x, m=8, nbits=4, iters=8, seed=1, device="cpu")
    queries = x[:7] + 0.02 * _gauss(5, 7, 32)
    ref = JaxPQIndex(jpq.PQCodec(index.codec.codebooks, 4), index.codes)
    want_s, want_i = ref.search(queries, 9, index_axis="index")
    got_s, got_i = index.search(queries, 9, index_axis="index")
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
