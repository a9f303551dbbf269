"""Host-side ranking-task input pipeline: doc tokenization + negative sampling.

The counterpart of ``convdr_tpu/train/ranking_data.py``, re-homed because
the JAX module's package pulls JAX in. The reference does both inside its
training loop (run_convdr_train.py:118-157): ``random.sample`` of
``num_negatives`` negatives (:123) and a ``title[SEP]text`` split +
tokenizer.encode per document (:127-137). Here:

  * documents are tokenized once and memoized (the same passage text recurs
    across epochs);
  * per-step negative sampling is a seeded numpy choice, the same draws as
    the JAX package's for the same ``RandomState``;
  * the batch arrives as dense ``doc_ids/doc_mask [B, 1+N, L]`` with the
    positive at slot 0 (ranking label 0, :169-170).
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import numpy as np

from convdr_torch.data.padding import pad_input_ids_with_mask


class DocumentTokenizerCache:
    """Memoized ``title[SEP]text`` document tokenization (train.py:127-137).

    Entries are int32 numpy arrays and the cache is LRU-bounded, so a large
    corpus does not grow host memory without limit.
    """

    def __init__(self, tokenizer, max_doc_length: int = 512,
                 max_entries: int = 500_000):
        self.tokenizer = tokenizer
        self.max_doc_length = max_doc_length
        self.max_entries = max_entries
        self._cache: "collections.OrderedDict[str, Tuple[np.ndarray, np.ndarray]]" = (
            collections.OrderedDict()
        )

    def encode(self, doc: str) -> Tuple[np.ndarray, np.ndarray]:
        hit = self._cache.get(doc)
        if hit is not None:
            self._cache.move_to_end(doc)
            return hit
        parts = doc.split("[SEP]")
        if len(parts) == 2:
            ids = self.tokenizer.encode(
                parts[0], text_pair=parts[1], add_special_tokens=True,
                max_length=self.max_doc_length,
            )
        else:
            ids = self.tokenizer.encode(
                doc, add_special_tokens=True, max_length=self.max_doc_length
            )
        padded, mask = pad_input_ids_with_mask(ids, self.max_doc_length)
        out = (np.asarray(padded, np.int32), np.asarray(mask, np.int32))
        self._cache[doc] = out
        if len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)
        return out


def choose_ranking_docs(
    documents: Sequence[Sequence[str]],
    num_negatives: int,
    rng: np.random.RandomState,
) -> List[List[str]]:
    """[B][1+M docs text] -> [B][1+num_negatives docs text]: each group's
    positive and a fresh sample of ``num_negatives`` of its remaining
    candidates (per step, like run_convdr_train.py:123). Groups short on
    negatives are topped up by sampling with replacement."""
    out = []
    for group in documents:
        negs = list(group[1:])
        if len(negs) >= num_negatives:
            chosen = rng.choice(len(negs), size=num_negatives, replace=False)
        else:
            chosen = rng.choice(max(len(negs), 1), size=num_negatives, replace=True)
            if not negs:  # degenerate group: repeat the positive as filler
                negs = [group[0]]
        out.append([group[0]] + [negs[c] for c in chosen])
    return out


def encode_ranking_docs(
    groups: Sequence[Sequence[str]], doc_cache: DocumentTokenizerCache
) -> Tuple[np.ndarray, np.ndarray]:
    """[B][K docs text] -> (doc_ids, doc_mask) [B, K, max_doc_length]."""
    length = doc_cache.max_doc_length
    k = len(groups[0]) if groups else 0
    ids = np.zeros((len(groups), k, length), np.int32)
    mask = np.zeros((len(groups), k, length), np.int32)
    for bi, docs in enumerate(groups):
        for ki, doc in enumerate(docs):
            ids[bi, ki], mask[bi, ki] = doc_cache.encode(doc)
    return ids, mask


def doc_rung(length_rungs: Sequence[int], longest: int, max_doc_length: int) -> int:
    """The smallest rung covering a batch's ``longest`` document (rungs
    ascending; the top rung must be ``max_doc_length``)."""
    return next((r for r in sorted(length_rungs) if r >= longest), max_doc_length)


def sample_ranking_batch(
    documents: Sequence[Sequence[str]],
    doc_cache: DocumentTokenizerCache,
    num_negatives: int,
    rng: np.random.RandomState,
    length_rungs: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """[B][1+M docs text] -> (doc_ids, doc_mask) [B, 1+num_negatives, L].

    documents[b][0] is the positive (:func:`choose_ranking_docs`).
    ``length_rungs`` trims ``L`` to the smallest rung covering the batch's
    longest document (:func:`doc_rung`). Doc embeddings are unchanged:
    pads never reach valid tokens.
    """
    ids, mask = encode_ranking_docs(choose_ranking_docs(documents, num_negatives, rng),
                                    doc_cache)
    if length_rungs:
        rung = doc_rung(length_rungs, int(mask.sum(axis=-1).max()), doc_cache.max_doc_length)
        ids, mask = ids[:, :, :rung], mask[:, :, :rung]
    return ids, mask
