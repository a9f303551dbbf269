"""ANCE-heritage line-processing functions (numpy, not torch).

The counterpart of ``convdr_tpu/data/process_fns.py``; parity with the
reference's data/process_fn.py: functions that turn one raw
text line into fixed-shape feature rows for ad-hoc (non-conversational)
training streams. The reference registers ``triple_process_fn`` as every
model's ``default_process_fn`` (model/models.py:272) even though the ConvDR
drivers never call it; kept here for full API coverage and for pre-training
ANCE-style teachers in-framework.

  * :func:`dual_process_fn`        -- ``qid \\t text`` -> (ids, mask, types, qid)
  * :func:`triple_process_fn`      -- ``query \\t pos \\t neg`` -> one row of
    interleaved (ids, mask) triples
  * :func:`triple2dual_process_fn` -- same input -> two (query, doc, label)
    rows, label 1 for the positive and 0 for the negative

Plus the ANCE *cache-stream* fns (reference data/tokenizing.py:133-220):
token-cache-backed record decoding and the qid/pos/negs training line
expansion that streams (query, doc, label) pairs or (query, pos, neg)
triples out of binary caches.

All outputs are numpy arrays sized to the cache/record length (right
padding, mask 1 for valid positions), ready to batch for the
encoders.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from convdr_torch.data.padding import pad_input_ids_with_mask


def _encode(text: str, tokenizer, max_seq_length: int):
    ids = tokenizer.encode(
        text.strip(), add_special_tokens=True, max_length=max_seq_length
    )
    ids, mask = pad_input_ids_with_mask(
        ids, max_seq_length, pad_token=tokenizer.pad_token_id
    )
    return (
        np.asarray(ids, np.int32),
        np.asarray(mask, np.int32),
        np.zeros(max_seq_length, np.int32),
    )


def dual_process_fn(line: str, i: int, tokenizer, max_seq_length: int) -> List[list]:
    cells = line.split("\t")
    if len(cells) != 2:
        raise ValueError(
            f"Line doesn't have correct length: {len(cells)}. Expected 2."
        )
    ids, mask, types = _encode(cells[1], tokenizer, max_seq_length)
    return [[ids, mask, types, int(cells[0])]]


def triple_process_fn(line: str, i: int, tokenizer, max_seq_length: int) -> List[list]:
    cells = line.split("\t")
    if len(cells) != 3:
        raise ValueError(
            f"Line doesn't have correct length: {len(cells)}. Expected 3."
        )
    features: list = []
    for text in cells:
        ids, mask, _types = _encode(text, tokenizer, max_seq_length)
        features += [ids, mask]
    return [features]


def triple2dual_process_fn(
    line: str, i: int, tokenizer, max_seq_length: int
) -> List[list]:
    cells = line.split("\t")
    if len(cells) != 3:
        raise ValueError(
            f"Line doesn't have correct length: {len(cells)}. Expected 3."
        )
    q_ids, q_mask, _ = _encode(cells[0], tokenizer, max_seq_length)
    pos_ids, pos_mask, _ = _encode(cells[1], tokenizer, max_seq_length)
    neg_ids, neg_mask, _ = _encode(cells[2], tokenizer, max_seq_length)
    return [
        [q_ids, q_mask, pos_ids, pos_mask, 1],
        [q_ids, q_mask, neg_ids, neg_mask, 0],
    ]


# ---------------------------------------------------------------------------
# ANCE cache-stream fns: records come from binary token caches, not raw text
# ---------------------------------------------------------------------------
def cache_record_features(
    record: Tuple[int, np.ndarray], *, query: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(length, padded ids) cache record -> (ids, mask, token_type_ids).

    Reference ``GetProcessingFn`` (data/tokenizing.py:133-161)
    minus the torch TensorDataset ceremony: the record already carries the
    padded id row; this derives the attention mask from the stored length and
    the reference's type ids (0 for queries, 1 for passages over valid
    positions, tokenizing.py:139).
    """
    length, ids = record
    max_len = ids.shape[0]
    length = min(int(length), max_len)
    mask = np.zeros(max_len, np.int32)
    mask[:length] = 1
    types = np.zeros(max_len, np.int32)
    if not query:
        types[:length] = 1
    return np.asarray(ids, np.int32), mask, types


def _parse_ance_line(line: str) -> Tuple[int, int, List[int]]:
    qid_s, pos_s, negs_s = line.rstrip("\n").split("\t")
    return int(qid_s), int(pos_s), [int(p) for p in negs_s.split(",")]


def training_pairs_from_caches(
    line: str, query_cache, passage_cache
) -> Iterator[tuple]:
    """``qid \\t pos_pid \\t neg,neg,...`` -> stream of labeled pairs.

    Reference ``GetTrainingDataProcessingFn`` (tokenizing.py:164-194): per
    negative pid, yields the (query, positive, label=1) pair and then the
    (query, negative, label=0) pair, re-reading records from the caches.
    Caches are any ``record = cache[id]`` mapping, e.g.
    :class:`convdr_torch.data.token_cache.TokenCache`.
    """
    qid, pos_pid, neg_pids = _parse_ance_line(line)
    q = cache_record_features(query_cache[qid], query=True)
    pos = cache_record_features(passage_cache[pos_pid])
    for neg_pid in neg_pids:
        neg = cache_record_features(passage_cache[neg_pid])
        yield (*q, *pos, 1)
        yield (*q, *neg, 0)


def triplet_training_data_from_caches(
    line: str, query_cache, passage_cache
) -> Iterator[tuple]:
    """``qid \\t pos_pid \\t neg,neg,...`` -> (query, pos, neg) triples.

    Reference ``GetTripletTrainingDataProcessingFn`` (tokenizing.py:197-220):
    one 9-tuple of (ids, mask, types) x (query, positive, negative) per
    negative pid.
    """
    qid, pos_pid, neg_pids = _parse_ance_line(line)
    q = cache_record_features(query_cache[qid], query=True)
    pos = cache_record_features(passage_cache[pos_pid])
    for neg_pid in neg_pids:
        neg = cache_record_features(passage_cache[neg_pid])
        yield (*q, *pos, *neg)
