"""The one traffic generator: a mix's parameters -> the token ids a cell feeds.

A mix (``mixes/<name>.json``) holds numbers only. Sizes (turns a session,
tokens a question, a rewrite, a passage) are drawn from the mix's own
``sizes_seed``, so every run of a cell serves the same set of sizes; the
run's ``--seed`` draws the order of the sessions and every token id. The
program receives only the arrays made here.

Id layout, after ConvDR's ``_concat_conversation_ids`` and
``pad_input_ids_with_mask``: a RoBERTa-style conversation is ``<s> q1 </s>
<s> q2 </s> ...``, a BERT-style one ``[CLS] q1 [SEP] q2 [SEP] ...``; the
result is cut to the concat length from the front of the conversation (a
cut sequence is all valid) or right-padded with the pad id and a 0 mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one purpose of one run: ``seed`` (any whole number)
    with the purpose's tags."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, *tags]))


# purposes of a run's draws
ORDER, TOKENS, SAMPLE = 1, 2, 3


def conversation_ids(questions: Sequence[np.ndarray], layout: dict) -> List[int]:
    """The concatenated ids of a conversation, current question last."""
    cls_id, sep_id = layout["cls_id"], layout["sep_id"]
    bert = layout["style"] == "bert"
    ids: List[int] = [cls_id] if bert else []
    for q in questions:
        if not bert:
            ids.append(cls_id)
        ids.extend(int(t) for t in q)
        ids.append(sep_id)
    return ids


def sentence_ids(tokens: np.ndarray, layout: dict) -> List[int]:
    """One sentence with the model's own specials: ``<s> t </s>`` or
    ``[CLS] t [SEP]``."""
    return [layout["cls_id"], *(int(t) for t in tokens), layout["sep_id"]]


def pad_row(ids: Sequence[int], length: int, pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask) of one row, cut or right-padded to ``length``."""
    n = min(len(ids), length)
    row = np.full(length, pad_id, np.int32)
    row[:n] = ids[:n]
    mask = np.zeros(length, np.int32)
    mask[:n] = 1
    return row, mask


def draw_tokens(g: np.random.Generator, n: int, layout: dict) -> np.ndarray:
    lo, hi = layout["token_ids"]
    return g.integers(lo, hi, size=n, dtype=np.int64)


def session_sizes(mix: dict, n_turns_total: int, g: np.random.Generator) -> List[np.ndarray]:
    """Question lengths of whole sessions until ``n_turns_total`` turns are
    drawn (the last session cut to fit): one array a session."""
    t_lo, t_hi = mix["turns_per_session"]
    q_lo, q_hi = mix["question_tokens"]
    sessions, total = [], 0
    while total < n_turns_total:
        turns = int(g.integers(t_lo, t_hi + 1))
        turns = min(turns, n_turns_total - total)
        sessions.append(g.integers(q_lo, q_hi + 1, size=turns))
        total += turns
    return sessions


@dataclass
class Queries:
    """A pool of conversational queries in serving order."""

    ids: np.ndarray  # [P, L] int32
    mask: np.ndarray  # [P, L] int32

    @property
    def valid(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    def call(self, i: int, per_call: int) -> Tuple[np.ndarray, np.ndarray]:
        """The ``i``-th call's rows: the pool cut into calls of ``per_call``
        rows, cycled."""
        n_calls = len(self.ids) // per_call
        lo = (i % n_calls) * per_call
        return self.ids[lo:lo + per_call], self.mask[lo:lo + per_call]


def conversation_queries(mix: dict, layout: dict, length: int, seed: int) -> Queries:
    """Every turn of the pooled sessions as one query row: turn k of a
    session carries its k questions so far."""
    sizes = session_sizes(mix, mix["pool_queries"], rng(mix["sizes_seed"]))
    order = rng(seed, ORDER).permutation(len(sizes))
    tok = rng(seed, TOKENS)
    ids, mask = [], []
    for s in order:
        questions = [draw_tokens(tok, int(n), layout) for n in sizes[s]]
        for k in range(1, len(questions) + 1):
            row, m = pad_row(conversation_ids(questions[:k], layout), length, layout["pad_id"])
            ids.append(row)
            mask.append(m)
    return Queries(np.stack(ids), np.stack(mask))


def doc_lengths(law: dict, n: int, g: np.random.Generator) -> np.ndarray:
    """Passage token counts (specials excluded) under ``law``."""
    if law["law"] != "lognormal":
        raise ValueError(f"unknown length law {law['law']!r}")
    x = np.exp(np.log(law["median"]) + law["sigma"] * g.standard_normal(n))
    return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)


def train_batches(mix: dict, layout: dict, seed: int) -> List[dict]:
    """``pool_steps`` KD + ranking batches as numpy arrays: the student's
    conversation (``concat_*`` [B, Lc]), the teacher's manual rewrite
    (``target_*`` [B, Lq]) and the teacher's documents, the positive first
    (``doc_*`` [B, 1 + negatives, Ld])."""
    b, k = mix["batch_size"], 1 + mix["num_negatives"]
    n_ex = mix["pool_steps"] * b
    g = rng(mix["sizes_seed"])
    sessions = session_sizes(mix, n_ex * mix["turns_per_session"][1], g)
    turn = [int(g.integers(1, len(sessions[i]) + 1)) for i in range(n_ex)]
    r_lo, r_hi = mix["rewrite_tokens"]
    rewrite = g.integers(r_lo, r_hi + 1, size=n_ex)
    # room for the two specials inside max_doc_length
    law = dict(mix["doc_tokens"], max=min(mix["doc_tokens"]["max"], mix["max_doc_length"] - 2))
    docs = doc_lengths(law, n_ex * k, g).reshape(n_ex, k)

    order = rng(seed, ORDER).permutation(n_ex)
    tok = rng(seed, TOKENS)
    lc, lq, ld, pad = (mix["max_concat_length"], mix["max_query_length"],
                       mix["max_doc_length"], layout["pad_id"])
    batches = []
    for step in range(mix["pool_steps"]):
        out = {n: [] for n in ("concat_ids", "concat_mask", "target_ids", "target_mask",
                               "doc_ids", "doc_mask")}
        for e in order[step * b:(step + 1) * b]:
            qs = [draw_tokens(tok, int(n), layout) for n in sessions[e][:turn[e]]]
            for name, (row, m) in (
                ("concat", pad_row(conversation_ids(qs, layout), lc, pad)),
                ("target", pad_row(sentence_ids(draw_tokens(tok, int(rewrite[e]), layout),
                                                layout), lq, pad)),
            ):
                out[name + "_ids"].append(row)
                out[name + "_mask"].append(m)
            rows = [pad_row(sentence_ids(draw_tokens(tok, int(n), layout), layout), ld, pad)
                    for n in docs[e]]
            out["doc_ids"].append(np.stack([r for r, _ in rows]))
            out["doc_mask"].append(np.stack([m for _, m in rows]))
        batches.append({n: np.ascontiguousarray(np.stack(v)) for n, v in out.items()})
    return batches


def passages(mix: dict, layout: dict, seed: int) -> List[np.ndarray]:
    """``passages`` corpus passages, each ``<s> t </s>`` / ``[CLS] t [SEP]``
    with its token count (specials excluded) under the mix's law; sizes
    from ``sizes_seed``, order and token ids from ``seed``."""
    law = dict(mix["doc_tokens"], max=min(mix["doc_tokens"]["max"], mix["max_seq_length"] - 2))
    sizes = doc_lengths(law, mix["passages"], rng(mix["sizes_seed"]))
    sizes = sizes[rng(seed, ORDER).permutation(len(sizes))]
    tok = rng(seed, TOKENS)
    return [np.asarray(sentence_ids(draw_tokens(tok, int(n), layout), layout), np.int32)
            for n in sizes]

