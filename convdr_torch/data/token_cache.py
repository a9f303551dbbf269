"""Binary token-cache: the on-disk data plane for tokenized corpora.

Format-compatible with the reference cache (record layout defined at
reference data/tokenizing.py:116 and read back at utils/util.py:362-381):

  record  = 4-byte big-endian length  +  ``max_seq_length`` int32 token ids
  sidecar = ``<base>_meta`` JSON: {"type", "total_number", "embedding_size"}

plus the ``pid2offset.pickle`` / ``offset2pid.pickle`` id maps
(tokenizing.py:63-75).

The reference reads one record at a time with ``f.seek``/``f.read``
(util.py:377-396). Here the cache is a single numpy memmap, so batched,
vectorized reads feed the encoder at memory bandwidth, and the
whole cache can be sliced per shard without per-record Python loops.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_LEN_BYTES = 4


class TokenCacheWriter:
    """Streams fixed-size records to disk and writes the meta sidecar."""

    def __init__(self, base_path: str, max_seq_length: int, dtype: str = "int32"):
        self.base_path = base_path
        self.max_seq_length = int(max_seq_length)
        self.dtype = np.dtype(dtype)
        self._f = open(base_path, "wb")
        self._count = 0

    def write(self, token_ids: Sequence[int], length: Optional[int] = None) -> int:
        """Append one record; returns its offset (dense row index)."""
        ids = np.asarray(token_ids, dtype=self.dtype)
        if ids.shape[0] > self.max_seq_length:
            ids = ids[: self.max_seq_length]
        n = int(ids.shape[0]) if length is None else min(int(length), self.max_seq_length)
        if ids.shape[0] < self.max_seq_length:
            ids = np.pad(ids, (0, self.max_seq_length - ids.shape[0]))
        self._f.write(n.to_bytes(_LEN_BYTES, "big"))
        self._f.write(ids.tobytes())
        offset = self._count
        self._count += 1
        return offset

    def write_raw(self, record: bytes) -> int:
        """Append an already-encoded record (len prefix + ids)."""
        assert len(record) == _LEN_BYTES + self.max_seq_length * self.dtype.itemsize
        self._f.write(record)
        offset = self._count
        self._count += 1
        return offset

    def close(self) -> None:
        self._f.close()
        meta = {
            "type": self.dtype.name,
            "total_number": self._count,
            "embedding_size": self.max_seq_length,
        }
        with open(self.base_path + "_meta", "w") as f:
            json.dump(meta, f)

    def abort(self) -> None:
        """Close without writing the meta sidecar (partial cache stays
        unreadable rather than masquerading as complete)."""
        self._f.close()

    def __enter__(self) -> "TokenCacheWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class TokenCache:
    """Memmap-backed reader over a token-cache file.

    Batch access returns ``(ids [B, L] int32, lengths [B] int32)`` numpy
    arrays ready for device transfer; the attention mask is derived on device
    from ``lengths`` (static shapes, no ragged tensors).
    """

    def __init__(self, base_path: str):
        self.base_path = base_path
        with open(base_path + "_meta", "r") as f:
            meta = json.load(f)
        self.dtype = np.dtype(meta["type"])
        self.total_number = int(meta["total_number"])
        self.max_seq_length = int(meta["embedding_size"])
        self.record_size = self.max_seq_length * self.dtype.itemsize + _LEN_BYTES
        # View the file as raw bytes [N, record_size]; slice out lens and ids.
        self._raw = np.memmap(base_path, dtype=np.uint8, mode="r").reshape(
            self.total_number, self.record_size
        )

    def __len__(self) -> int:
        return self.total_number

    def _decode(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        lens = (
            np.ascontiguousarray(rows[:, :_LEN_BYTES])
            .view(">u4")
            .astype(np.int32)
            .reshape(-1)
        )
        ids = np.ascontiguousarray(rows[:, _LEN_BYTES:]).view(self.dtype)
        ids = ids.reshape(rows.shape[0], self.max_seq_length)
        return ids, lens

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, dtype=np.int64)
        return self._decode(self._raw[idx])

    def slice(self, start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._decode(self._raw[start:stop])

    def __getitem__(self, key: int) -> Tuple[int, np.ndarray]:
        """Reference-compatible single-record access: (length, ids)."""
        if key < 0 or key >= self.total_number:
            raise IndexError(
                f"Index {key} out of bounds for cache of size {self.total_number}"
            )
        ids, lens = self.batch([key])
        return int(lens[0]), ids[0]

    def iter_batches(
        self,
        batch_size: int,
        *,
        shard_index: int = 0,
        num_shards: int = 1,
        pad_to_full: bool = True,
        shuffle_seed: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (ids, lengths, row_offsets) batches for one data shard.

        Sharding is contiguous-by-stride (row ``i`` belongs to shard
        ``i % num_shards``), matching the reference's round-robin record
        assignment (utils/util.py:423-424) so per-shard outputs concatenate
        into the same global order. Final partial batches are padded with
        repeated last rows (row_offsets mark validity with -1) to keep batch
        shapes fixed.

        ``shuffle_seed`` iterates a seeded permutation of the FULL cache
        before shard filtering -- the reference EmbeddingCache's ``seed >= 0``
        iteration order (utils/util.py:364-368,398-402), so all shards see
        the same global permutation.
        """
        if shuffle_seed is not None:
            perm = np.random.RandomState(shuffle_seed).permutation(
                self.total_number
            ).astype(np.int64)
            rows = perm[shard_index::num_shards]
        else:
            rows = np.arange(
                shard_index, self.total_number, num_shards, dtype=np.int64
            )
        for i in range(0, len(rows), batch_size):
            chunk = rows[i : i + batch_size]
            valid = len(chunk)
            if pad_to_full and valid < batch_size:
                pad = np.full(batch_size - valid, chunk[-1], dtype=np.int64)
                chunk = np.concatenate([chunk, pad])
            ids, lens = self.batch(chunk)
            offsets = chunk.copy()
            if pad_to_full and valid < batch_size:
                offsets[valid:] = -1
            yield ids, lens, offsets


def save_id_maps(out_dir: str, offset2pid: Sequence[int]) -> None:
    """Write pid<->offset maps exactly like tokenizing.py:63-75."""
    pid2offset = {int(pid): i for i, pid in enumerate(offset2pid)}
    with open(os.path.join(out_dir, "pid2offset.pickle"), "wb") as f:
        pickle.dump(pid2offset, f, protocol=4)
    with open(os.path.join(out_dir, "offset2pid.pickle"), "wb") as f:
        pickle.dump(list(int(p) for p in offset2pid), f, protocol=4)


def load_offset2pid(processed_dir: str) -> list:
    with open(os.path.join(processed_dir, "offset2pid.pickle"), "rb") as f:
        return pickle.load(f)


def load_query_id_maps(cache_base_path: str) -> Tuple[dict, list]:
    """(qid2offset, offset2qid) persisted by ``tokenize_queries_file``."""
    with open(cache_base_path + "_qid2offset.pickle", "rb") as f:
        qid2offset = pickle.load(f)
    with open(cache_base_path + "_offset2qid.pickle", "rb") as f:
        offset2qid = pickle.load(f)
    return qid2offset, offset2qid


def attention_mask_from_lengths(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """[B] lengths -> [B, L] 0/1 mask (host-side helper)."""
    return (np.arange(max_len)[None, :] < lengths[:, None]).astype(np.int32)
