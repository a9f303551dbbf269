"""HNSW approximate nearest-neighbour index on the host (FAISS ``IndexHNSWFlat``).

The counterpart of ``convdr_tpu/retrieval/hnsw.py``: an L2 HNSW graph (the
C++ of ``csrc/host/hnsw.cpp``, the port's copy of the JAX package's
``native/hnsw.cpp``, built by :func:`convdr_torch.native_io.load_hnsw`)
and the reference's ``DenseHNSWFlatIndexer`` (utils/dpr_utils.py:156-221)
on top of it. The indexer turns inner-product search into L2 search with
one auxiliary dimension: ``sqrt(phi - |v|^2)`` for every document and ``0``
for every query, where ``phi`` is the largest squared document norm, so the
L2-nearest document is the one of largest inner product. ``phi`` is a
constant of the whole corpus, so all documents go in through one
``index_data`` call.

No driver reaches this module: it is a library entry point on the host,
as in the JAX package. The exact search on the card is the production
path. Both packages build the same graph from the same rows at one build
thread (the same source, the same compiler flags).
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import List, Sequence, Tuple

import numpy as np

from convdr_torch import native_io

logger = logging.getLogger(__name__)

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


class HnswIndex:
    """ctypes wrapper over the C++ HNSW graph (L2 metric)."""

    def __init__(self, dim: int, m: int = 32, ef_construction: int = 200,
                 ef_search: int = 128, seed: int = 42):
        self._lib = native_io.load_hnsw()
        self.dim = dim
        self._handle = self._lib.convdr_hnsw_create(dim, m, ef_construction,
                                                    ef_search, seed)

    def __len__(self) -> int:
        return int(self._lib.convdr_hnsw_size(self._handle))

    def add(self, vectors: np.ndarray, num_threads: int = 1) -> None:
        """Insert rows. ``num_threads > 1`` inserts concurrently with a lock
        a node (as hnswlib does): the recall contract holds, but the graph
        depends on the threads' interleaving. One thread (the default)
        builds the same graph on every run."""
        vecs = np.ascontiguousarray(vectors, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"vectors must be [N, {self.dim}], got {vecs.shape}")
        ptr = vecs.ctypes.data_as(_F32P)
        if num_threads > 1:
            self._lib.convdr_hnsw_add_parallel(self._handle, ptr, vecs.shape[0], num_threads)
        else:
            self._lib.convdr_hnsw_add(self._handle, ptr, vecs.shape[0])

    def set_ef_search(self, ef_search: int) -> None:
        self._lib.convdr_hnsw_set_ef_search(self._handle, ef_search)

    def search(
        self, queries: np.ndarray, k: int, num_threads: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest rows of each query: (squared L2 distances [Q, k] f32
        ascending, row ids [Q, k] int64, -1 where the index holds fewer).
        ``num_threads``: 0 = one a core, 1 = serial, N = exactly N; queries
        are independent and the graph is not changed, so the results are
        the same at any count."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}], got {q.shape}")
        nq = q.shape[0]
        dists = np.empty((nq, k), np.float32)
        ids = np.empty((nq, k), np.int64)
        if num_threads == 0:
            num_threads = os.cpu_count() or 1
        self._lib.convdr_hnsw_search_parallel(
            self._handle, q.ctypes.data_as(_F32P), nq, k,
            dists.ctypes.data_as(_F32P), ids.ctypes.data_as(_I64P), num_threads,
        )
        return dists, ids

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.convdr_hnsw_free(handle)
            self._handle = None


class DenseHNSWFlatIndexer:
    """The reference's DPR indexer: inner-product search over an L2 HNSW
    graph, with database ids kept beside the graph's row ids."""

    def __init__(self, vector_sz: int, buffer_size: int = 50000,
                 store_n: int = 512, ef_search: int = 128,
                 ef_construction: int = 200, num_threads: int = 1):
        self.buffer_size = buffer_size
        # build threads: 1 (the default) builds the same graph every run
        self.num_threads = num_threads
        self.index_id_to_db_id: List[object] = []
        if store_n > 128:
            logger.warning(
                "store_n=%d as HNSW degree M is large (reference default); "
                "build time and memory grow with M", store_n,
            )
        # one auxiliary dimension for the IP -> L2 conversion
        self.index = HnswIndex(
            vector_sz + 1, m=store_n, ef_construction=ef_construction,
            ef_search=ef_search,
        )
        self.phi = 0.0

    def index_data(self, data: Sequence[Tuple[object, np.ndarray]]) -> None:
        """Index every (db id, vector) pair; one call per indexer."""
        if self.phi > 0:
            raise RuntimeError(
                "DPR HNSWF index needs to index all data at once, "
                "results will be unpredictable otherwise."
            )
        phi = 0.0
        for _id, vec in data:
            phi = max(phi, float((np.asarray(vec) ** 2).sum()))
        self.phi = phi
        for start in range(0, len(data), self.buffer_size):
            chunk = data[start : start + self.buffer_size]
            vectors = np.stack([np.asarray(v, np.float32).reshape(-1) for _id, v in chunk])
            norms = (vectors ** 2).sum(axis=1)
            aux = np.sqrt(np.maximum(phi - norms, 0.0)).astype(np.float32)
            self.index_id_to_db_id.extend(_id for _id, _v in chunk)
            self.index.add(np.concatenate([vectors, aux[:, None]], axis=1),
                           num_threads=self.num_threads)
            logger.info("data indexed %d", len(self.index_id_to_db_id))

    def search_knn(
        self, query_vectors: np.ndarray, top_docs: int
    ) -> List[Tuple[List[object], List[float]]]:
        """(db ids, squared L2 distances in the augmented space) of each
        query's ``top_docs`` nearest documents; None past the index size."""
        q = np.asarray(query_vectors, np.float32)
        aux = np.zeros((q.shape[0], 1), np.float32)
        scores, indexes = self.index.search(np.concatenate([q, aux], axis=1), top_docs)
        return [
            ([self.index_id_to_db_id[i] if i >= 0 else None for i in row_ids], list(row_scores))
            for row_ids, row_scores in zip(indexes, scores)
        ]
