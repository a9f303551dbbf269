"""Parallel corpus tokenization: collection file -> binary token cache.

The counterpart of ``convdr_tpu/data/tokenize_pipeline.py``, itself the
reference's worker fan-out and merge (data/tokenizing.py:14-75,
utils/util.py:620-658):

  * worker ``i`` tokenizes lines ``idx % num_workers == i`` and writes a
    split file of ``pid(8B big-endian) + len(4B) + int32 ids`` records
    (tokenizing.py:116, util.py:632-639);
  * the merge streams the splits in worker order through the native host
    library (:func:`convdr_torch.native_io.merge_token_splits`), strips the
    pid prefix, assigns dense offsets, and the pipeline writes the cache's
    ``_meta`` and the ``pid2offset``/``offset2pid`` maps (tokenizing.py:39-75).

The offset order is worker-major, not line order, as in the reference and
the JAX package, so the caches are byte-identical. Workers are started
with ``spawn`` (a process that holds a CUDA context must not fork) and
import only this module's chain, which loads no ``torch``.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
from typing import List, Optional

import numpy as np

from convdr_torch.core.config import DataConfig
from convdr_torch.data.padding import pad_input_ids
from convdr_torch.data.token_cache import TokenCacheWriter, save_id_maps
from convdr_torch.data.tokenizers import load_tokenizer
from convdr_torch.native_io import merge_token_splits

_PID_BYTES = 8
_LEN_BYTES = 4


def encode_passage_record(
    pid: int, text: str, tokenizer, max_seq_length: int,
    title: Optional[str] = None,
) -> bytes:
    """One split-file record (tokenizing.py:78-116 semantics)."""
    if title is not None:
        ids = tokenizer.encode(
            title, text_pair=text, add_special_tokens=True,
            max_length=max_seq_length,
        )
    else:
        ids = tokenizer.encode(
            text, add_special_tokens=True, max_length=max_seq_length
        )
    length = min(len(ids), max_seq_length)
    padded = pad_input_ids(ids, max_seq_length)
    return (
        pid.to_bytes(_PID_BYTES, "big")
        + length.to_bytes(_LEN_BYTES, "big")
        + np.asarray(padded, np.int32).tobytes()
    )


def _parse_line(line: str, fmt: str, max_doc_character: int):
    """-> (pid, title_or_None, text) or None to skip the line."""
    line = line.strip()
    if not line:
        return None
    if fmt == "jsonl":
        obj = json.loads(line)
        return int(obj["id"]), obj["title"], obj["text"][:max_doc_character]
    parts = line.split("\t")
    if len(parts) < 2:
        return None
    try:
        pid = int(parts[0])
    except ValueError:
        return None
    return pid, None, parts[1].rstrip()[:max_doc_character]


def _worker(args) -> int:
    (
        worker_id,
        num_workers,
        in_path,
        out_base,
        tokenizer_kind,
        tokenizer_path,
        max_seq_length,
        max_doc_character,
    ) = args
    tokenizer = load_tokenizer(tokenizer_kind, tokenizer_path)
    fmt = "jsonl" if in_path.endswith(".jsonl") else "tsv"
    count = 0
    with open(in_path, "r", encoding="utf-8") as in_f, open(
        f"{out_base}_split{worker_id}", "wb"
    ) as out_f:
        for idx, line in enumerate(in_f):
            if idx % num_workers != worker_id:
                continue
            parsed = _parse_line(line, fmt, max_doc_character)
            if parsed is None:
                continue
            pid, title, text = parsed
            out_f.write(
                encode_passage_record(pid, text, tokenizer, max_seq_length, title)
            )
            count += 1
    return count


def tokenize_collection(
    collection_path: str,
    out_data_dir: str,
    *,
    tokenizer_kind: str = "roberta",
    tokenizer_path: str = "tiny",
    config: DataConfig = DataConfig(),
    num_workers: Optional[int] = None,
) -> int:
    """Full pipeline: fan-out tokenize, merge, id maps. Returns record count."""
    os.makedirs(out_data_dir, exist_ok=True)
    out_base = os.path.join(out_data_dir, "passages")
    if os.path.exists(out_base):
        raise FileExistsError(f"{out_base} already exists; not overwriting")
    workers = num_workers or config.num_tokenize_workers
    jobs = [
        (
            i,
            workers,
            collection_path,
            out_base,
            tokenizer_kind,
            tokenizer_path,
            config.max_seq_length,
            config.max_doc_character,
        )
        for i in range(workers)
    ]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pool.map(_worker, jobs)
    else:
        for job in jobs:
            _worker(job)

    splits = [f"{out_base}_split{i}" for i in range(workers)]
    record_bytes = _LEN_BYTES + config.max_seq_length * 4
    max_records = sum(
        os.path.getsize(s) // (_PID_BYTES + record_bytes) for s in splits
    )
    pids = merge_token_splits(splits, out_base, record_bytes, max_records)
    for split in splits:
        os.remove(split)
    meta = {
        "type": "int32",
        "total_number": int(len(pids)),
        "embedding_size": config.max_seq_length,
    }
    with open(out_base + "_meta", "w") as f:
        json.dump(meta, f)
    save_id_maps(out_data_dir, [int(p) for p in pids])
    return len(pids)


def tokenize_queries_file(
    queries_path: str,
    out_path: str,
    *,
    tokenizer,
    max_query_length: int = 64,
) -> int:
    """qid\\tquery tsv -> query token cache + persisted qid<->offset maps.

    QueryPreprocessingFn parity (reference data/tokenizing.py:119-130): the
    cache at ``out_path`` gets ``<out_path>_qid2offset.pickle`` and
    ``<out_path>_offset2qid.pickle`` siblings
    (:func:`convdr_torch.data.token_cache.load_query_id_maps` reads them).
    Purely numeric qids are ints, as the reference casts them; CAsT-style
    ids like "31_4" stay strings.
    """
    offset2qid: List = []
    with TokenCacheWriter(out_path, max_query_length) as writer:
        with open(queries_path, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2:
                    continue
                qid = int(parts[0]) if parts[0].isdigit() else parts[0]
                ids = tokenizer.encode(
                    parts[1].rstrip(),
                    add_special_tokens=True,
                    max_length=max_query_length,
                )
                writer.write(ids)
                offset2qid.append(qid)
    with open(out_path + "_qid2offset.pickle", "wb") as f:
        pickle.dump({q: i for i, q in enumerate(offset2qid)}, f, protocol=4)
    with open(out_path + "_offset2qid.pickle", "wb") as f:
        pickle.dump(offset2qid, f, protocol=4)
    return len(offset2qid)
