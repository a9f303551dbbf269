"""Calls that are valid against the JAX package's public search classes run
in the port with the same keywords and give the JAX package's results (CPU).

``BlockedSearcher(config)`` takes no device (None means the card, a raise
without one) and accepts ``mesh`` / ``index_axis``; ``IVFIndex.search``
and ``PQIndex.search`` accept ``index_axis``. A mesh is a torch
``DeviceMesh`` (anything else raises ``TypeError``); over a one-rank gloo
mesh the searcher returns the unmeshed result bit for bit. The
``convdr_torch.parallel`` entry points take the JAX package's keywords.
Tolerances: equal row ids, f32 scores within 1e-5 (another summation
order).
"""

import importlib.util
import inspect
import os


import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.parallel import dryrun, mesh, sharded_search
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_torch.retrieval.pq_index import PQIndex
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.parallel import mesh as jmesh
from convdr_tpu.parallel import sharded_search as jsharded
from convdr_tpu.ops import pq as jpq
from convdr_tpu.retrieval import ivf as jivf
from convdr_tpu.retrieval.pq_index import PQIndex as JaxPQIndex
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxBlockedSearcher


def _load_graft():
    path = os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_blocked_searcher_mesh_is_a_device_mesh_and_world1_equals_unmeshed():
    with pytest.raises(TypeError, match="DeviceMesh"):
        BlockedSearcher(tcfg.SearchConfig(), device="cpu", mesh=object())
    q, p = _gauss(6, 5, 16), _gauss(7, 700, 16)
    offsets = np.arange(700, dtype=np.int64) * 2
    want = BlockedSearcher(tcfg.SearchConfig(), device="cpu").search_arrays(q, p, offsets, 9)
    with dryrun.single_rank():
        got = BlockedSearcher(tcfg.SearchConfig(), device="cpu",
                              mesh=mesh.get_mesh(("index",))).search_arrays(q, p, offsets, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


PARALLEL_PAIRS = [
    (mesh.get_mesh, jmesh.get_mesh), (mesh.shard_batch, jmesh.shard_batch),
    (mesh.replicate, jmesh.replicate), (mesh.pad_to_multiple, jmesh.pad_to_multiple),
    (sharded_search.sharded_flat_ip_topk, jsharded.sharded_flat_ip_topk),
    (sharded_search.sharded_ivf_topk, jsharded.sharded_ivf_topk),
    (sharded_search.sharded_pq_topk, jsharded.sharded_pq_topk),
    (dryrun.dryrun_multichip, _load_graft().dryrun_multichip),
]


@pytest.mark.parametrize("ours,theirs", PARALLEL_PAIRS, ids=lambda f: f.__name__)
def test_parallel_entry_points_take_the_jax_keywords(ours, theirs):
    """Every parameter of the JAX function is one of the port's, in the
    same order and with the same default."""
    mine = inspect.signature(ours).parameters
    for name, param in inspect.signature(theirs).parameters.items():
        assert name in mine, name
        assert mine[name].default == param.default, name
    names = list(mine)
    order = [names.index(n) for n in inspect.signature(theirs).parameters]
    assert order == sorted(order)


def test_get_mesh_checks_sizes_as_jax_does():
    with dryrun.single_rank():
        with pytest.raises(ValueError, match=r"Mesh wants 2 devices \({'data': 2}\) but 1 are"):
            mesh.get_mesh(("data",), (2,))
        m = mesh.get_mesh(("data", "index"))
        assert (mesh.axis_size(m, "data"), mesh.axis_size(m, "index")) == (1, 1)
        x = {"a": torch.arange(6).reshape(3, 2)}
        assert torch.equal(mesh.shard_batch(m, x, "data")["a"], x["a"])
        assert mesh.replicate(m, x) is x
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.get_mesh()


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
