"""k-means on the device (the FAISS ``Clustering`` counterpart).

The counterpart of ``convdr_tpu/ops/kmeans.py``, which trains the IVF coarse
quantizer. Both Lloyd phases are products on the device:

  * assignment: ``argmax(x @ c.T - |c|^2/2)`` == nearest centroid in L2,
    one [B, K] product per row block, no [B, K, D] difference tensor;
  * update: the one-hot of the assignment contracted against the block
    (``onehot.T @ x``), the sums by cluster as one product in f32, whose
    order of summation does not depend on the scheduling (``index_add_``'s
    atomics on the card would).

Everything is f32 with TF32 off. (The JAX package rounds rows and centroids
to bf16 for both products; on separated data both give the same
assignments, so the IVF layout built on them is the same.) Empty clusters
are reseeded between iterations by splitting the largest cluster
(:func:`_split_empty`, numpy, the JAX package's function).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from convdr_torch.core.device import pick_device
from convdr_torch.ops.exact_search import grouped_topk_last_axis
from convdr_torch.retrieval.blocks import bf16_dtype
from convdr_torch.utils.transfer import device_put_chunked

logger = logging.getLogger(__name__)

# Assignment/update block: bounds the [B, K] score and one-hot buffers.
_KMEANS_BLOCK_ROWS = 65536

# Host-chunk byte cap for streamed assignment inputs (assign_top_t): bounds
# the input slab uploaded at once.
_ASSIGN_CHUNK_BYTES = int(2 * (1 << 30))


def _block_rows_for(n: int, k: int, requested: int) -> int:
    """Cap the row block so the [B, K] buffers stay near 1.5 GB (6 bytes a
    cell, the JAX package's budget; f32 scores + f32 one-hot take 8)."""
    cap = max(4096, int((1.5 * (1 << 30)) // (6 * max(k, 1))))
    return max(1, min(requested, cap, n))


def _lloyd_iter(
    x: torch.Tensor, c: torch.Tensor, block_rows: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over ``x`` [N, D] f32 with centroids ``c`` [K, D]
    f32, both on one device. Returns (sums [K, D] f32, counts [K] f32,
    objective = sum over rows of (|c_a|^2/2 - x.c_a), f32 scalar)."""
    n, d = x.shape
    k = c.shape[0]
    chalf = 0.5 * (c * c).sum(dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    obj = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, n, block_rows):
        blk = x[lo : lo + block_rows]
        scores = blk @ c.T - chalf[None, :]
        assign = scores.argmax(dim=1)  # the first maximal index on ties
        onehot = torch.zeros((blk.shape[0], k), dtype=torch.float32, device=x.device)
        onehot.scatter_(1, assign[:, None], 1.0)
        sums += onehot.T @ blk
        counts += onehot.sum(dim=0)
        obj -= scores.gather(1, assign[:, None]).sum()
    return sums, counts, obj


def _split_empty(
    c: np.ndarray, counts: np.ndarray, eps: float = 1.0 / 1024.0
) -> Tuple[np.ndarray, int]:
    """Reseed empty clusters by splitting the currently largest ones."""
    c = c.copy()
    counts = counts.copy()
    empties = np.flatnonzero(counts == 0)
    for j in empties:
        donor = int(np.argmax(counts))
        if counts[donor] < 2:
            break  # fewer distinct points than clusters; leave as-is
        c[j] = c[donor] * (1.0 + eps)
        c[donor] = c[donor] * (1.0 - eps)
        counts[j] = counts[donor] // 2
        counts[donor] -= counts[donor] // 2
    return c, len(empties)


def fit_kmeans(
    x: np.ndarray,
    nlist: int,
    *,
    iters: int = 20,
    seed: int = 42,
    sample_max: int | None = None,
    block_rows: int = _KMEANS_BLOCK_ROWS,
    device=None,
) -> np.ndarray:
    """Fit ``nlist`` centroids with Lloyd's algorithm on ``device`` (None:
    the card).

    ``sample_max`` caps the training set with a seeded choice without
    replacement; the initial centroids are a second seeded choice (the JAX
    package's draws, verbatim). Stops after ``iters`` iterations, or once no
    cluster was empty and the objective moved by at most 1e-7 of itself.
    Returns centroids [nlist, D] f32.
    """
    device = pick_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if nlist < 1 or nlist > n:
        raise ValueError(f"nlist={nlist} must be in [1, n_rows={n}]")
    rng = np.random.Generator(np.random.PCG64(seed))
    if sample_max is not None and n > sample_max:
        x = x[rng.choice(n, size=sample_max, replace=False)]
        n = sample_max
    c = x[rng.choice(n, size=nlist, replace=False)].copy()

    block_rows = _block_rows_for(n, nlist, block_rows)
    x_dev = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    prev_obj = np.inf
    for it in range(iters):
        sums, counts, obj = _lloyd_iter(x_dev, torch.from_numpy(c).to(device), block_rows)
        sums = sums.cpu().numpy()
        counts = counts.cpu().numpy()
        obj = float(obj)
        nonzero = counts > 0
        new_c = c.copy()
        new_c[nonzero] = sums[nonzero] / counts[nonzero, None]
        new_c, n_empty = _split_empty(new_c, counts)
        logger.info(
            "kmeans iter %d/%d: obj=%.4f empties=%d max/mean=%.2f",
            it + 1, iters, obj, n_empty,
            counts.max() / max(counts.mean(), 1e-9),
        )
        c = new_c
        if n_empty == 0 and abs(prev_obj - obj) <= 1e-7 * max(1.0, abs(obj)):
            break  # converged
        prev_obj = obj
    return c.astype(np.float32)


def _assign_topt_dev(
    x: torch.Tensor, c: torch.Tensor, t: int, block_rows: int
) -> torch.Tensor:
    """[N, t] int64: each row's ``t`` nearest centroids, nearest first (the
    lower centroid id on ties). ``x`` any float dtype, scored in f32."""
    chalf = 0.5 * (c * c).sum(dim=1)
    outs = []
    for lo in range(0, x.shape[0], block_rows):
        scores = x[lo : lo + block_rows].float() @ c.T - chalf[None, :]
        if t == 1:
            outs.append(scores.argmax(dim=1, keepdim=True))
        else:
            outs.append(grouped_topk_last_axis(scores, t)[1])
    return torch.cat(outs)


def assign_top_t(
    x: np.ndarray,
    centroids: np.ndarray,
    t: int = 1,
    *,
    block_rows: int = _KMEANS_BLOCK_ROWS,
    device=None,
) -> np.ndarray:
    """For each row, its ``t`` nearest centroids (L2), nearest first.

    [N, t] int32. Rows upload in host chunks of at most
    ``_ASSIGN_CHUNK_BYTES`` in their own dtype (f32, bf16, or ``uint16`` bf16
    bit patterns, the block-file layout: half the bytes, no host cast) and
    are scored in f32 on the device.
    """
    device = pick_device(device)
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.view(bf16_dtype())
    elif x.dtype not in (np.dtype(np.float32), bf16_dtype()):
        x = x.astype(np.float32)
    t = min(t, centroids.shape[0])
    n = x.shape[0]
    if n == 0:
        return np.zeros((0, t), np.int32)
    c_dev = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    br = _block_rows_for(n, centroids.shape[0], block_rows)
    host_chunk = max(br, _ASSIGN_CHUNK_BYTES // max(1, x.itemsize * int(x.shape[1])))
    outs = []
    for lo in range(0, n, host_chunk):
        hi = min(n, lo + host_chunk)
        out = _assign_topt_dev(
            device_put_chunked(x[lo:hi], device=device), c_dev, t, min(br, hi - lo)
        )
        outs.append(out.cpu().numpy().astype(np.int32))
    return outs[0] if len(outs) == 1 else np.concatenate(outs)
