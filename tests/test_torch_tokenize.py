"""The port's tokenize driver against the JAX package's on the same seeded
collection: the token cache, its ``_meta``, ``pid2offset`` /
``offset2pid`` and the query cache with its qid maps must be byte-identical
(the offsets are worker-major, so the worker count is part of the
contract)."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from convdr_torch.data import tokenize_pipeline as tpipe
from convdr_torch.data.token_cache import TokenCache
from convdr_torch.drivers import tokenize_collection as torch_tok
from convdr_tpu.drivers import tokenize_collection as jax_tok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("river stone apple orbit violin harbor granite lantern meadow cipher "
         "quartz ember willow falcon").split()


def write_inputs(work, fmt, seed=0):
    rng = np.random.RandomState(seed)
    path = os.path.join(work, f"collection.{fmt}")
    with open(path, "w") as f:
        for i in range(41):
            pid = int(rng.randint(0, 10**9))
            text = " ".join(rng.choice(WORDS, rng.randint(1, 40)))
            if fmt == "tsv":
                f.write(f"{pid}\t{text}\n")
                if i % 13 == 5:
                    f.write("\n")             # blank: skipped
                    f.write("notanid\tx\n")   # bad pid: skipped
                    f.write(f"{pid + 1}\n")   # no text: skipped
            else:
                title = " ".join(rng.choice(WORDS, rng.randint(1, 4)))
                f.write(json.dumps({"id": pid, "title": title, "text": text}) + "\n")
    queries = os.path.join(work, "queries.dev.tsv")
    with open(queries, "w") as f:
        for i in range(9):
            qid = f"{i // 3 + 1}_{i % 3 + 1}" if i % 2 else str(100 + i)
            f.write(f"{qid}\t{' '.join(rng.choice(WORDS, rng.randint(1, 30)))}\n")
    return path, queries


def argv(collection, out, model_type, workers, queries):
    return ["--collection", collection, "--out_data_dir", out, "--model_type", model_type,
            "--max_seq_length", "48", "--max_doc_character", "150",
            "--num_workers", str(workers), "--queries", queries,
            "--max_query_length", "16"]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
@pytest.mark.parametrize("fmt", ["tsv", "jsonl"])
def test_cache_and_maps_byte_identical_to_jax(tmp_path, fmt, model_type, workers):
    collection, queries = write_inputs(str(tmp_path), fmt)
    n_torch = torch_tok.main(argv(collection, str(tmp_path / "torch"), model_type,
                                  workers, queries))
    n_jax = jax_tok.main(argv(collection, str(tmp_path / "jax"), model_type, workers,
                              queries))
    assert n_torch == n_jax == 41
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == sorted([
        "passages", "passages_meta", "pid2offset.pickle", "offset2pid.pickle",
        "queries.dev", "queries.dev_meta", "queries.dev_qid2offset.pickle",
        "queries.dev_offset2qid.pickle",
    ])
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    cache = TokenCache(str(tmp_path / "torch" / "passages"))
    assert len(cache) == 41 and cache.max_seq_length == 48


def test_offsets_are_worker_major(tmp_path):
    collection, queries = write_inputs(str(tmp_path), "tsv", seed=3)
    torch_tok.main(argv(collection, str(tmp_path / "out"), "rdot_nll", 3, queries))
    with open(collection) as f:
        lines = f.readlines()
    # worker w takes lines idx % 3 == w, in line order; splits merge 0, 1, 2
    want = []
    for w in range(3):
        for idx, line in enumerate(lines):
            parsed = tpipe._parse_line(line, "tsv", 150)
            if idx % 3 == w and parsed is not None:
                want.append(parsed[0])
    assert len(want) == 41
    with open(tmp_path / "out" / "offset2pid.pickle", "rb") as f:
        assert pickle.load(f) == want


def test_second_run_refuses_to_overwrite(tmp_path):
    collection, queries = write_inputs(str(tmp_path), "tsv")
    torch_tok.main(argv(collection, str(tmp_path / "out"), "rdot_nll", 1, queries))
    with pytest.raises(FileExistsError):
        torch_tok.main(argv(collection, str(tmp_path / "out"), "rdot_nll", 1, queries))


def test_worker_import_chain_loads_no_torch(tmp_path):
    """Spawned workers import the pipeline module: it must not pull in torch
    (seconds and memory per worker)."""
    code = ("import sys, convdr_torch.drivers.tokenize_collection, "
            "convdr_torch.data.tokenize_pipeline\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
