"""Product quantization for embedding storage (FAISS ``IndexPQ`` family).

The counterpart of ``convdr_tpu/ops/pq.py``. Every device phase is a
product on the card, in f32 with TF32 off:

  * FIT: all ``M`` subspace k-means problems run as one batched Lloyd
    iteration (``bmm`` assignment, one-hot ``bmm`` update);
  * ENCODE: blocked batched nearest-centroid assignment, the same ``bmm``;
  * SEARCH (ADC): the flat scan is a product with a query-shared one-hot,

        one_hot(codes, K).reshape(B, M*K) @ LUT.reshape(Q, M*K).T

    built once per row block, 0/1-valued and exact in f32.

ADC scores: by default the LUT is rounded to bf16 (as the JAX package's
default precision does) and summed in f32; ``exact=True`` keeps it in f32.
No product here returns bf16: a bf16 ``matmul`` in PyTorch rounds its sums.
:func:`pq_adc_oracle` is the numpy reference (near-tie set equality).

The codec's host parts (``_split_empty_subspace``, ``decode``, ``lut``,
4-bit packing, ``save``/``load``) are the JAX package's, so either package
reads the other's ``pq_codebooks.npz`` and builds the same LUTs.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from convdr_torch.core.device import pick_device
from convdr_torch.ops.exact_search import NEG_INF, grouped_topk_last_axis, merge_topk
from convdr_torch.retrieval.blocks import bf16_dtype
from convdr_torch.utils.transfer import device_put_chunked

logger = logging.getLogger(__name__)

PQ_META_FILENAME = "pq_codebooks.npz"

# [M, B, K] score + one-hot buffers of the batched Lloyd / encode programs:
# ~6 bytes a cell in the JAX package's budget, capped near 1.5 GB.
_PQ_BUFFER_BYTES = int(1.5 * (1 << 30))

# Byte cap on the f32 copy of one encode() host chunk on the device.
_ENCODE_CHUNK_BYTES = int(2 * (1 << 30))


def _fit_block_rows(m: int, k: int) -> int:
    return max(256, _PQ_BUFFER_BYTES // (6 * m * k))


def _onehot(idx: torch.Tensor, k: int) -> torch.Tensor:
    """f32 one-hot of integer ``idx`` [..., M] -> [..., M, k]."""
    out = torch.zeros((*idx.shape, k), dtype=torch.float32, device=idx.device)
    return out.scatter_(-1, idx.long()[..., None], 1.0)


# ---------------------------------------------------------------------------
# codebook fitting: M subspace k-means as one batched Lloyd program
# ---------------------------------------------------------------------------
def _pq_lloyd_iter(
    x: torch.Tensor, c: torch.Tensor, block_rows: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration over all subspaces at once.

    x [M, N, dsub] f32, c [M, K, dsub] f32 on one device. Returns (sums
    [M, K, dsub] f32, counts [M, K] f32, objective f32). Assignment = argmax
    of ``<x, c> - |c|^2/2`` in f32: subspaces are 4-16 dims with tiny score
    gaps, and an assignment error here is the codec's quality.
    """
    m, n, dsub = x.shape
    k = c.shape[1]
    chalf = 0.5 * (c * c).sum(dim=-1)  # [M, K]
    sums = torch.zeros((m, k, dsub), dtype=torch.float32, device=x.device)
    counts = torch.zeros((m, k), dtype=torch.float32, device=x.device)
    obj = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, n, block_rows):
        blk = x[:, lo : lo + block_rows]  # [M, B, dsub]
        scores = torch.bmm(blk, c.transpose(1, 2)) - chalf[:, None, :]  # [M, B, K]
        assign = scores.argmax(dim=-1)  # [M, B]
        onehot = _onehot(assign, k)  # [M, B, K]
        sums += torch.bmm(onehot.transpose(1, 2), blk)
        counts += onehot.sum(dim=1)
        obj -= scores.gather(-1, assign[..., None]).sum()
    return sums, counts, obj


def _split_empty_subspace(
    c: np.ndarray, counts: np.ndarray, eps: float = 1.0 / 1024.0
) -> Tuple[np.ndarray, int]:
    """Reseed empty clusters per subspace by splitting its largest one
    (FAISS ``Clustering::post_process_centroids`` semantics, applied
    independently inside each of the M subspaces)."""
    c = c.copy()
    counts = counts.copy()
    n_empty = 0
    for mi in range(c.shape[0]):
        empties = np.flatnonzero(counts[mi] == 0)
        n_empty += len(empties)
        for j in empties:
            donor = int(np.argmax(counts[mi]))
            if counts[mi, donor] < 2:
                break
            c[mi, j] = c[mi, donor] * (1.0 + eps)
            c[mi, donor] = c[mi, donor] * (1.0 - eps)
            counts[mi, j] = counts[mi, donor] // 2
            counts[mi, donor] -= counts[mi, donor] // 2
    return c, n_empty


def _pq_assign_dev(
    x: torch.Tensor, c: torch.Tensor, block_rows: int, r: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """codes [N, M] int64: nearest centroid per subspace per row.

    ``x`` is the raw [N, D] row block in any float dtype (scored in f32);
    ``r`` (optional [D, D]) applies the OPQ rotation before the split.
    """
    n, d = x.shape
    m, k, dsub = c.shape
    chalf = 0.5 * (c * c).sum(dim=-1)  # [M, K]
    outs = []
    for lo in range(0, n, block_rows):
        blk = x[lo : lo + block_rows].float()
        if r is not None:
            blk = blk @ r
        sub = blk.reshape(blk.shape[0], m, dsub).transpose(0, 1)  # [M, B, dsub]
        scores = torch.bmm(sub, c.transpose(1, 2)) - chalf[:, None, :]  # [M, B, K]
        outs.append(scores.argmax(dim=-1).T)
    return torch.cat(outs)


def _fit_codebooks(
    x: np.ndarray, m: int, k: int, iters: int, seed: int, device: torch.device
) -> np.ndarray:
    """Lloyd loop over all M subspaces at once on ``x`` [N, D] (already
    subsampled). Returns codebooks [M, K, dsub] f32."""
    n, d = x.shape
    dsub = d // m
    rng = np.random.Generator(np.random.PCG64(seed))
    xs = np.ascontiguousarray(x.reshape(n, m, dsub).transpose(1, 0, 2))  # [M, N, dsub]
    # init: a shared row subset, each subspace taking its slice
    c = xs[:, rng.choice(n, size=k, replace=False), :].copy()
    block_rows = min(_fit_block_rows(m, k), n)
    x_dev = torch.from_numpy(xs).to(device)
    prev_obj = np.inf
    for it in range(iters):
        sums, counts, obj = _pq_lloyd_iter(x_dev, torch.from_numpy(c).to(device), block_rows)
        sums = sums.cpu().numpy()
        counts = counts.cpu().numpy()
        obj = float(obj)
        nonzero = counts > 0
        new_c = c.copy()
        new_c[nonzero] = sums[nonzero] / counts[nonzero][:, None]
        new_c, n_empty = _split_empty_subspace(new_c, counts)
        logger.info("pq fit iter %d/%d: obj=%.4f empties=%d", it + 1, iters, obj, n_empty)
        c = new_c
        if n_empty == 0 and abs(prev_obj - obj) <= 1e-7 * max(1.0, abs(obj)):
            break
        prev_obj = obj
    return c.astype(np.float32)


def _rotate_dev(x: np.ndarray, r: np.ndarray, device: torch.device) -> np.ndarray:
    """``x @ r`` in f32 on ``device``, back on the host."""
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    rt = torch.from_numpy(np.ascontiguousarray(r, np.float32)).to(device)
    return (xt @ rt).cpu().numpy()


class PQCodec:
    """A trained product quantizer: M codebooks of K centroids each.

    codebooks [M, K, dsub] float32, D = M * dsub, K = 2**nbits. Codes are
    stored unpacked as uint8 [N, M] (nbits=4 values occupy 0..15).
    ``rotation`` (optional, [D, D] orthogonal) is an OPQ transform: rows
    encode as ``x @ R`` and query LUTs build from ``q @ R``; orthogonality
    keeps rotated inner products equal to the originals.
    """

    def __init__(
        self,
        codebooks: np.ndarray,
        nbits: int,
        rotation: Optional[np.ndarray] = None,
    ):
        cb = np.asarray(codebooks, np.float32)
        if cb.ndim != 3:
            raise ValueError(f"codebooks must be [M, K, dsub], got {cb.shape}")
        if nbits not in (4, 8):
            raise ValueError(f"nbits must be 4 or 8, got {nbits}")
        if cb.shape[1] != (1 << nbits):
            raise ValueError(
                f"codebooks have K={cb.shape[1]} centroids but nbits={nbits} "
                f"implies K={1 << nbits}"
            )
        self.codebooks = cb
        self.nbits = int(nbits)
        d = cb.shape[0] * cb.shape[2]
        if rotation is not None:
            rotation = np.asarray(rotation, np.float32)
            if rotation.shape != (d, d):
                raise ValueError(f"rotation must be [{d}, {d}]")
        self.rotation = rotation

    # -- geometry -------------------------------------------------------
    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def code_bytes(self) -> int:
        return self.m  # unpacked uint8 per subspace

    # -- training -------------------------------------------------------
    @classmethod
    def fit(
        cls,
        sample: np.ndarray,
        m: int,
        nbits: int = 8,
        *,
        iters: int = 20,
        seed: int = 42,
        sample_max: Optional[int] = None,
        opq_iters: int = 0,
        device=None,
    ) -> "PQCodec":
        """Train M subspace codebooks on ``sample`` [N, D] on ``device``
        (None: the card).

        ``sample_max`` caps the training rows (None = ``256 * 2**nbits``).
        ``opq_iters`` > 0 also learns an OPQ rotation by alternating
        optimization: fit codebooks on the rotated sample, reconstruct,
        solve the orthogonal Procrustes problem ``min_R |XR - X_hat|`` by
        an SVD of ``X^T X_hat`` (the product on the device, the SVD on the
        host), re-rotate, repeat; a final full-depth fit runs on the
        converged rotation.
        """
        device = pick_device(device)
        x = np.asarray(sample, np.float32)
        if x.ndim != 2 or x.shape[0] < (1 << nbits):
            raise ValueError(f"need [N>={1 << nbits}, D] training sample, got {x.shape}")
        n, d = x.shape
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m}")
        k = 1 << nbits
        if sample_max is None:
            sample_max = 256 * k
        rng = np.random.Generator(np.random.PCG64(seed))
        if n > sample_max:
            x = x[rng.choice(n, size=sample_max, replace=False)]
            n = sample_max

        if not opq_iters:
            return cls(_fit_codebooks(x, m, k, iters, seed, device), nbits)

        rotation = np.eye(d, dtype=np.float32)
        inner = max(4, iters // 4)
        for t in range(opq_iters):
            xr = _rotate_dev(x, rotation, device)
            codec = cls(_fit_codebooks(xr, m, k, inner, seed, device), nbits)
            xhat = codec.decode(codec.encode(xr, device=device))  # rotated-space recon
            cov = _rotate_dev(x.T, xhat, device)  # X^T X_hat [D, D]
            u, _, vt = np.linalg.svd(cov)
            rotation = np.ascontiguousarray((u @ vt).astype(np.float32))
            err = float(((xr - xhat) ** 2).mean())
            logger.info("opq iter %d/%d: recon_mse=%.6f", t + 1, opq_iters, err)
        xr = _rotate_dev(x, rotation, device)
        return cls(_fit_codebooks(xr, m, k, iters, seed, device), nbits, rotation)

    # -- encode / decode --------------------------------------------------
    def encode(self, emb: np.ndarray, *, device=None) -> np.ndarray:
        """[N, D] float -> codes [N, M] uint8 on ``device`` (None: the card).

        Rows upload in host chunks in their own dtype (bf16 and ``uint16``
        bf16 bit patterns at half the bytes) and are assigned in f32.
        """
        device = pick_device(device)
        x = np.asarray(emb)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"embeddings must be [N, {self.dim}]")
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self.m), np.uint8)
        if x.dtype == np.uint16:
            x = x.view(bf16_dtype())
        elif x.dtype not in (np.dtype(np.float32), bf16_dtype()):
            x = x.astype(np.float32)
        out = np.empty((n, self.m), np.uint8)
        c_dev = torch.from_numpy(self.codebooks).to(device)
        r_dev = (
            torch.from_numpy(self.rotation).to(device) if self.rotation is not None else None
        )
        block_rows = _fit_block_rows(self.m, self.ksub)
        host_chunk = max(1, min(16 * block_rows, _ENCODE_CHUNK_BYTES // (4 * self.dim)))
        for lo in range(0, n, host_chunk):
            hi = min(n, lo + host_chunk)
            codes = _pq_assign_dev(
                device_put_chunked(x[lo:hi], device=device),
                c_dev,
                min(block_rows, hi - lo),
                r_dev,
            )
            out[lo:hi] = codes.cpu().numpy()
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes [N, M] -> reconstructed [N, D] float32 (host-side). With an
        OPQ rotation the reconstruction is de-rotated back to the original
        space."""
        codes = np.asarray(codes)
        if codes.ndim != 2 or codes.shape[1] != self.m:
            raise ValueError(f"codes must be [N, {self.m}]")
        out = np.empty((codes.shape[0], self.dim), np.float32)
        for mi in range(self.m):
            out[:, mi * self.dsub : (mi + 1) * self.dsub] = self.codebooks[
                mi, codes[:, mi].astype(np.int64)
            ]
        if self.rotation is not None:
            out = out @ self.rotation.T
        return out

    def lut(self, queries: np.ndarray) -> np.ndarray:
        """Per-query ADC tables [Q, M, K] f32: lut[q,m,k] = <q_m, c_mk>
        (host-side, the JAX package's numpy, so both build equal tables).
        With an OPQ rotation queries rotate first."""
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}]")
        if self.rotation is not None:
            q = q @ self.rotation
        qs = q.reshape(q.shape[0], self.m, self.dsub)
        return np.einsum("qmd,mkd->qmk", qs, self.codebooks, dtype=np.float32).astype(
            np.float32
        )

    # -- persistence ------------------------------------------------------
    def save(self, data_dir: str) -> str:
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, PQ_META_FILENAME)
        extra = {"rotation": self.rotation} if self.rotation is not None else {}
        np.savez(path, codebooks=self.codebooks, nbits=self.nbits, **extra)
        return path

    @classmethod
    def load(cls, data_dir: str) -> "PQCodec":
        path = os.path.join(data_dir, PQ_META_FILENAME)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no PQ codebooks at {path}")
        with np.load(path) as z:
            return cls(
                z["codebooks"],
                int(z["nbits"]),
                z["rotation"] if "rotation" in z.files else None,
            )

    @classmethod
    def load_optional(cls, data_dir: str) -> Optional["PQCodec"]:
        try:
            return cls.load(data_dir)
        except FileNotFoundError:
            return None


# ---------------------------------------------------------------------------
# 4-bit code packing
# ---------------------------------------------------------------------------
def pack_codes_4bit(codes: np.ndarray) -> np.ndarray:
    """[N, M] uint8 nibble values (0..15) -> [N, M/2] packed bytes.

    Byte j holds subspaces (2j, 2j+1): ``codes[:, 2j] | codes[:, 2j+1] <<
    4`` (FAISS packs pq4 the same low-nibble-first way).
    """
    codes = np.asarray(codes)
    if codes.dtype != np.uint8 or codes.ndim != 2:
        raise ValueError(f"codes must be uint8 [N, M], got {codes.dtype}")
    if codes.shape[1] % 2:
        raise ValueError(f"m={codes.shape[1]} must be even to pack")
    if codes.max(initial=0) > 15:
        raise ValueError("codes exceed 4 bits; packing is nbits=4 only")
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_codes_4bit(packed: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`pack_codes_4bit`: [N, M/2] -> [N, M]."""
    packed = np.asarray(packed, np.uint8)
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.uint8)
    out[:, 0::2] = packed & 0xF
    out[:, 1::2] = packed >> 4
    return out


def unpack_codes_4bit_dev(packed: torch.Tensor) -> torch.Tensor:
    """Device unpack [..., M/2] uint8 -> [..., M]."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


# ---------------------------------------------------------------------------
# ADC search
# ---------------------------------------------------------------------------
def pq_adc_oracle(lut: np.ndarray, codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy ADC reference: scores[q,n] = sum_m lut[q,m,codes[n,m]].

    Returns (scores [Q, k] f32 desc, indices [Q, k] int32), ties broken by
    lower row index.
    """
    qn, m, k_sub = lut.shape
    codes = np.asarray(codes, np.int64)
    scores = np.zeros((qn, codes.shape[0]), np.float32)
    for mi in range(m):
        scores += lut[:, mi, :][:, codes[:, mi]]
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(scores, order, axis=1).astype(np.float32),
        order.astype(np.int32),
    )


def round_lut(lut: torch.Tensor, exact: bool) -> torch.Tensor:
    """The LUT the ADC sums: rounded to bf16 (the JAX package's default
    precision) and held in f32, or kept f32 with ``exact``."""
    return lut.float() if exact else lut.to(torch.bfloat16).float()


def adc_block_scores(
    lut_flat: torch.Tensor,
    codes_block: torch.Tensor,
    ksub: int,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """ADC scores for one row block as one product with a query-shared
    one-hot.

    lut_flat [Q, M*K] f32, codes_block [B, M] integer. ``precision=None``
    rounds the LUT entries to bf16 (the JAX package's default precision);
    ``"highest"`` keeps them f32. The one-hot is f32 and the product f32
    with TF32 off, so the sum is of exact products in f32. Returns [Q, B].
    """
    b, m = codes_block.shape
    lut_flat = round_lut(lut_flat, precision is not None)
    onehot = _onehot(codes_block, ksub).reshape(b, m * ksub)
    return lut_flat @ onehot.T


def _adc_block_rows(m: int, ksub: int, requested: int) -> int:
    """Cap the row block so the [B, M*K] one-hot stays near 512 MB at the
    JAX package's 2 bytes a cell (1 GB in the port's f32)."""
    cap = max(1024, (512 << 20) // (2 * m * ksub))
    return max(1, min(requested, cap))


def pq_flat_topk(
    lut: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    ksub: int,
    *,
    block_rows: int = 1 << 18,
    valid_rows: int = -1,
    exact: bool = False,
    group: int = 32,
    packed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ADC top-k over PQ codes: scan row blocks, one ADC product each.

    lut   [Q, M, K] f32 per-query tables (:meth:`PQCodec.lut`) on the codes'
          device;
    codes [N, M] uint8, or [N, M/2] packed nibbles with ``packed=True``
          (nbits=4 only), resident on the device;
    valid_rows: logical corpus size if codes are padded (-1 = N);
    ``exact`` keeps the LUT entries f32 (tests and oracle parity).

    Returns (scores [Q, k] desc f32, row indices [Q, k] int64, -1 padded),
    ordered by (ADC score desc, index asc): each block's stable top-k, the
    blocks merged in order with the earlier block first on ties.
    """
    qn, m, k_tab = lut.shape
    n = codes.shape[0]
    code_width = m // 2 if packed else m
    if packed and ksub != 16:
        raise ValueError("packed codes are nbits=4 only (ksub=16)")
    if k_tab != ksub or codes.shape[1] != code_width:
        raise ValueError(
            f"lut [Q, M, K]={tuple(lut.shape)} vs codes [N, {code_width}]="
            f"{tuple(codes.shape)} with ksub={ksub}, packed={packed}"
        )
    lut_flat = lut.reshape(qn, m * ksub)
    precision = "highest" if exact else None
    valid = n if valid_rows < 0 else min(int(valid_rows), n)
    k_eff = min(k, n)
    block_rows = _adc_block_rows(m, ksub, max(1, min(block_rows, n)))
    out_s = out_i = None
    for lo in range(0, n, block_rows):
        block = codes[lo : lo + block_rows]
        if packed:
            block = unpack_codes_4bit_dev(block)
        scores = adc_block_scores(lut_flat, block, ksub, precision)
        if valid - lo < block.shape[0]:
            scores[:, max(valid - lo, 0):] = NEG_INF
        blk_s, blk_i = grouped_topk_last_axis(scores, min(k_eff, block.shape[0]), group)
        blk_i = blk_i + lo
        if out_s is None:
            out_s, out_i = blk_s, blk_i
            if out_s.shape[1] < k_eff:
                pad = k_eff - out_s.shape[1]
                out_s = F.pad(out_s, (0, pad), value=NEG_INF)
                out_i = F.pad(out_i, (0, pad), value=-1)
        else:
            out_s, out_i = merge_topk(out_s, out_i, blk_s, blk_i, k_eff)
    if out_s is None:  # empty corpus
        out_s = torch.empty((qn, 0), dtype=torch.float32, device=lut.device)
        out_i = torch.empty((qn, 0), dtype=torch.int64, device=lut.device)
    if k_eff < k:
        out_s = F.pad(out_s, (0, k - k_eff), value=NEG_INF)
        out_i = F.pad(out_i, (0, k - k_eff), value=-1)
    out_i = torch.where(out_s == NEG_INF, torch.full_like(out_i, -1), out_i)
    return out_s, out_i
