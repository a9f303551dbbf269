"""IVF recall of both packages' builds on a scaled-down copy of the
``chip_smoke.py`` phase-4d mixture (CPU).

Phase 4d clusters 1,048,576 rows of a 4096-centre Gaussian mixture (centres
N(0, I), noise N(0, I)) into 1024 k-means clusters: 256 rows a centre, four
centres a cluster. The copy here keeps those ratios at N = 32,768 (128
centres, nlist 32) and D = 768. The same rows go through the port's
``IVFIndex.build`` (f32 k-means) and the JAX package's (bf16 k-means), and
each index is read three ways:

  * the recall@100 of its search against the exact top 100, by ``nprobe``;
  * the recall an L2-ranked probe would reach, |c|^2 - 2 q.c ascending in
    place of the inner product q.c the index ranks by (the share of the
    exact top 100 whose sub-list the probe takes);
  * the search's recall by the size of the query's own cluster (its
    nearest centroid by L2), in terciles.

``python tests/test_torch_ann_recall.py`` prints these readings.
"""

import json

import numpy as np
import pytest
import torch

from convdr_torch.ops.exact_search import topk_oracle
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_tpu.retrieval.ivf import IVFIndex as JaxIVFIndex

N, D, CENTRES, NLIST, Q, K = 32768, 768, 128, 32, 256, 100
NPROBES = (1, 2, 4, 8)


def mixture(seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    centres = rng.standard_normal((CENTRES, D), dtype=np.float32)
    which = rng.integers(0, CENTRES, N + Q)
    x = centres[which] + rng.standard_normal((N + Q, D), dtype=np.float32)
    return x[:N], x[N:]


def readings(index, rows, queries, exact_i):
    """Recall@K by nprobe of the search, of an inner-product and an L2
    probe ranking over the index's sub-lists, and the search's recall by
    the size (in rows) of the query's nearest-by-L2 cluster, in terciles."""
    rowids = np.asarray(index.rowids)
    cent = np.asarray(index.centroids, np.float32)
    sub_of = np.empty(len(rows), np.int64)
    sub, slot = np.nonzero(rowids >= 0)
    sub_of[rowids[sub, slot]] = sub
    target = sub_of[exact_i]  # [Q, K] the sub-list of each exact hit
    ip = queries @ cent.T
    l2 = (cent * cent).sum(1)[None, :] - 2 * ip
    # a cluster's sub-lists share one centroid: its size is theirs summed
    sizes = (rowids >= 0).sum(1)
    cluster = np.unique(cent, axis=0, return_inverse=True)[1].reshape(-1)
    cluster_rows = np.bincount(cluster, weights=sizes)
    own = cluster[np.argmin(l2, axis=1)]
    own_rows = cluster_rows[own]
    cuts = np.quantile(own_rows, [1 / 3, 2 / 3])
    tercile = np.digitize(own_rows, cuts)
    out = {}
    for nprobe in NPROBES:
        _s, got = index.search(queries, K, nprobe=nprobe)
        per_q = np.array([len(set(g) & set(w)) / K for g, w in zip(got, exact_i)])

        def covered(rank):
            probe = np.argsort(rank, axis=1, kind="stable")[:, :nprobe]
            return float(np.mean([np.isin(t, p).mean() for t, p in zip(target, probe)]))

        out[nprobe] = {
            "search": float(per_q.mean()),
            "ip_probe": covered(-ip),
            "l2_probe": covered(l2),
            "by_cluster_tercile": [float(per_q[tercile == t].mean()) for t in range(3)],
        }
    out["cluster_rows_terciles"] = [float(c) for c in cuts]
    return out


def run_study():
    rows, queries = mixture()
    exact_i = topk_oracle(queries, rows, K)[1]
    port = IVFIndex.build(rows, NLIST, iters=20, seed=0, device=torch.device("cpu"))
    jax_index = JaxIVFIndex.build(rows, NLIST, iters=20, seed=0)
    return {"port": readings(port, rows, queries, exact_i),
            "jax": readings(jax_index, rows, queries, exact_i),
            "port_stats": port.stats, "jax_stats": jax_index.stats}


@pytest.fixture(scope="module")
def study():
    return run_study()


@pytest.mark.parametrize("nprobe", NPROBES)
def test_port_build_recalls_like_the_jax_build(study, nprobe):
    """The port's f32 k-means builds an index whose search recall is the
    JAX package's bf16 k-means build's, within 0.02 (near-ties may move a
    few rows to another cluster), overall and in each cluster-size
    tercile."""
    ours, theirs = study["port"][nprobe], study["jax"][nprobe]
    assert abs(ours["search"] - theirs["search"]) <= 0.02
    np.testing.assert_allclose(ours["by_cluster_tercile"], theirs["by_cluster_tercile"],
                               atol=0.02)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_search_misses_only_unprobed_sublists(study, package):
    """The IVF contract: a query misses an exact hit iff the hit's sub-list
    ranks outside its top-``nprobe`` by inner product, so the search's
    recall equals the inner-product probe's coverage of the exact top 100
    (to 1e-9)."""
    for nprobe in NPROBES:
        got = study[package][nprobe]
        assert abs(got["search"] - got["ip_probe"]) <= 1e-9, (nprobe, got)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_study(), indent=1))
