"""Conversational query dataset: topics jsonl -> fixed-shape numpy batches.

Re-implements the reference ``ConvSearchDataset`` contract
(reference utils/util.py:432-617) with the same six query modes and
special-token layouts:

  * ``no_res`` / ``man_can`` / ``auto_can`` (training always): concatenated
    conversation. RoBERTa layout ``<s> q1 </s> <s> q2 </s> ... <s> qk </s>``
    (util.py:491-519); DPR/BERT layout ``[CLS] q1 [SEP] q2 [SEP] ...``
    (util.py:486-498). ``man_can``/``auto_can`` inject the previous canonical
    response after a ``<response>`` marker token when >= 2 responses exist
    (util.py:500-512), and record it into the raw sequence list.
  * ``target`` / ``output`` / ``raw``: single-query encode of the manual
    rewrite / rewriter output / last raw utterance (util.py:526-554).

Training examples additionally carry the tokenized manual ``target`` for KD
(util.py:559-566) and, for the ranking task, positive/negative document text
(util.py:479-481). Unlike the reference's per-example torch tensors, batches
here are dense numpy arrays ready for a single host->device transfer.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from convdr_torch.data.padding import pad_input_ids_with_mask

RESPONSE_TOKEN = "<response>"


@dataclasses.dataclass
class ConvSearchExample:
    qid: str
    concat_ids: List[int]
    concat_mask: List[int]
    target_ids: Optional[List[int]] = None
    target_mask: Optional[List[int]] = None
    doc_pos: Optional[str] = None
    doc_negs: Optional[List[str]] = None
    raw_sequences: Optional[List[str]] = None


def _concat_conversation_ids(
    tokenizer,
    sentences: Sequence[str],
    *,
    is_bert_style: bool,
    response_text: Optional[str],
) -> List[int]:
    """Build the concatenated conversational id sequence (pre-padding)."""
    ids: List[int] = []
    cls_id = tokenizer.cls_token_id
    sep_id = tokenizer.sep_token_id
    if is_bert_style:
        ids.append(cls_id)
    for sent in sentences[:-1]:
        if not is_bert_style:
            ids.append(cls_id)
        ids.extend(tokenizer.convert_tokens_to_ids(tokenizer.tokenize(sent)))
        ids.append(sep_id)
    if response_text is not None:
        if not is_bert_style:
            ids.append(cls_id)
        ids.extend(tokenizer.convert_tokens_to_ids([RESPONSE_TOKEN]))
        ids.extend(tokenizer.convert_tokens_to_ids(tokenizer.tokenize(response_text)))
        ids.append(sep_id)
    if not is_bert_style:
        ids.append(cls_id)
    ids.extend(tokenizer.convert_tokens_to_ids(tokenizer.tokenize(sentences[-1])))
    ids.append(sep_id)
    return ids


def parse_topics_file(
    filename: str,
    tokenizer,
    *,
    query_mode: str = "no_res",
    model_type: str = "rdot_nll",
    max_concat_length: int = 256,
    max_query_length: int = 64,
    mode: str = "train",
    ranking_task: bool = False,
) -> List[ConvSearchExample]:
    examples: List[ConvSearchExample] = []
    is_bert_style = model_type == "dpr"
    with open(filename, encoding="utf-8") as f:
        for line in f:
            record = json.loads(line)
            input_sents: List[str] = record["input"]
            target_sent: str = record["target"]
            auto_sent: str = record.get("output", "no")
            raw_sent: str = record["input"][-1]
            # Reference parity (util.py:463-466): these modes REQUIRE the
            # response field -- a missing key must raise, not silently
            # degrade the run to no_res semantics.
            if query_mode == "man_can":
                responses = record["manual_response"]
            elif query_mode == "auto_can":
                responses = record["automatic_response"]
            else:
                responses = []
            topic_number = record.get("topic_number")
            query_number = record.get("query_number")
            if topic_number is not None:
                qid = f"{topic_number}_{query_number}"
            else:
                qid = str(record["qid"])
            sequences = list(input_sents)

            doc_pos = doc_negs = None
            if mode == "train" and ranking_task:
                doc_pos = record["doc_pos"]
                doc_negs = record["doc_negs"]

            if mode == "train" or query_mode in ("no_res", "man_can", "auto_can"):
                response_text = None
                if query_mode in ("man_can", "auto_can") and len(responses) >= 2:
                    response_text = responses[-2]
                    sequences.insert(-1, response_text)
                raw_ids = _concat_conversation_ids(
                    tokenizer,
                    input_sents,
                    is_bert_style=is_bert_style,
                    response_text=response_text,
                )
                concat_ids, concat_mask = pad_input_ids_with_mask(
                    raw_ids, max_concat_length
                )
            elif query_mode in ("target", "output", "raw"):
                text = {"target": target_sent, "output": auto_sent, "raw": raw_sent}[
                    query_mode
                ]
                ids = tokenizer.encode(
                    text, add_special_tokens=True, max_length=max_query_length
                )
                concat_ids, concat_mask = pad_input_ids_with_mask(
                    ids, max_query_length
                )
            else:
                raise KeyError(f"Unsupported query mode {query_mode!r}")

            target_ids = target_mask = None
            if mode == "train":
                tids = tokenizer.encode(
                    target_sent, add_special_tokens=True, max_length=max_query_length
                )
                target_ids, target_mask = pad_input_ids_with_mask(
                    tids, max_query_length
                )

            examples.append(
                ConvSearchExample(
                    qid=qid,
                    concat_ids=concat_ids,
                    concat_mask=concat_mask,
                    target_ids=target_ids,
                    target_mask=target_mask,
                    doc_pos=doc_pos,
                    doc_negs=doc_negs,
                    raw_sequences=sequences,
                )
            )
    return examples


class ConvSearchDataset:
    """In-memory dataset over one or more topics jsonl files."""

    def __init__(
        self,
        filenames: Sequence[str],
        tokenizer,
        *,
        query_mode: str = "no_res",
        model_type: str = "rdot_nll",
        max_concat_length: int = 256,
        max_query_length: int = 64,
        mode: str = "train",
        ranking_task: bool = False,
    ):
        self.mode = mode
        self.ranking_task = ranking_task
        self.examples: List[ConvSearchExample] = []
        for fn in filenames:
            self.examples.extend(
                parse_topics_file(
                    fn,
                    tokenizer,
                    query_mode=query_mode,
                    model_type=model_type,
                    max_concat_length=max_concat_length,
                    max_query_length=max_query_length,
                    mode=mode,
                    ranking_task=ranking_task,
                )
            )

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, i: int) -> ConvSearchExample:
        return self.examples[i]

    def collate(self, batch: Sequence[ConvSearchExample]) -> Dict[str, object]:
        """Batch -> dict of dense numpy arrays (+ python lists for text)."""
        out: Dict[str, object] = {
            "qid": [ex.qid for ex in batch],
            "concat_ids": np.asarray([ex.concat_ids for ex in batch], np.int32),
            "concat_mask": np.asarray([ex.concat_mask for ex in batch], np.int32),
        }
        if self.mode == "train":
            out["target_ids"] = np.asarray(
                [ex.target_ids for ex in batch], np.int32
            )
            out["target_mask"] = np.asarray(
                [ex.target_mask for ex in batch], np.int32
            )
            if self.ranking_task:
                out["documents"] = [[ex.doc_pos] + list(ex.doc_negs) for ex in batch]
        else:
            out["history_utterances"] = [ex.raw_sequences for ex in batch]
        return out

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 42,
        drop_last: bool = False,
    ) -> Iterator[Dict[str, object]]:
        order = np.arange(len(self.examples))
        if shuffle:
            order = np.random.RandomState(seed).permutation(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            yield self.collate([self.examples[j] for j in idx])
