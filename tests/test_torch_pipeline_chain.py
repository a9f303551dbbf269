"""The port's five-program chain on the raw CAsT-19 formats, against the JAX
package's (the mirror of ``tests/test_pipeline_chain.py``): cast19 ETL ->
tokenize -> train (KD to a frozen teacher) -> embed -> inference, each
package through its own drivers (``--no_cuda --arch_size tiny`` for the
port), from one shared initial model dir (a JAX tiny init in the
reference's ``pytorch_model.bin`` format, student and teacher). The corpus
is embedded in f32 (``--dtype float32``): the two packages' bf16 forwards
round differently, and their contract there is top-k sets, not ranks.

Held: the ETL outputs and the token caches byte-identical, CAR pids from
10,000,000 in the run, the TREC runs byte-identical (the same pids in the
same order for every turn) and the metrics equal, and the port's run equal
to an exact numpy search of its own blocks.
"""

import json
import os

import jax
import numpy as np
import pytest

from convdr_torch.drivers import gen_passage_embeddings as t_embed
from convdr_torch.drivers import run_convdr_inference as t_infer
from convdr_torch.drivers import run_convdr_train as t_train
from convdr_torch.drivers import tokenize_collection as t_tokenize
from convdr_torch.etl import cast19 as t19
from convdr_torch.etl.cbor_car import encode_item
from convdr_torch.evaluation.metrics import parse_trec_run
from convdr_torch.retrieval.blocks import iter_embedding_blocks
from convdr_tpu.drivers import gen_passage_embeddings as j_embed
from convdr_tpu.drivers import run_convdr_inference as j_infer
from convdr_tpu.drivers import run_convdr_train as j_train
from convdr_tpu.drivers import tokenize_collection as j_tokenize
from convdr_tpu.etl import cast19 as j19

TOPICS = ["cats", "dogs", "fish", "birds"]
PACKAGES = {
    "torch": (t19, t_tokenize, t_train, t_embed, t_infer, ["--no_cuda"]),
    "jax": (j19, j_tokenize, j_train, j_embed, j_infer, ["--no_mesh"]),
}


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw CAsT-19 inputs (8 CAR + 8 MARCO passages over 4 topics, one
    MARCO duplicate, 4 two-turn conversations, qrels in both id spaces)
    and the shared initial model dir."""
    work = tmp_path_factory.mktemp("torch_chain_raw")
    cast = work / "cast"
    os.makedirs(cast)
    with open(work / "car.cbor", "wb") as f:
        for i in range(8):
            f.write(encode_item([1, f"carpid{i}",
                                 [[0, f"car facts about {TOPICS[i % 4]} number {i}"]]]))
    with open(work / "marco.tsv", "w") as f:
        for i in range(8):
            f.write(f"{i}\tmarco facts about {TOPICS[i % 4]} number {i}\n")
    with open(work / "dup.txt", "w") as f:
        f.write("CAR_carpid0:MARCO_7\n")
    topics = [{"number": 31 + t, "title": f"topic {t}", "description": "",
               "turn": [{"number": 1, "raw_utterance": f"tell me about {topic}"},
                        {"number": 2, "raw_utterance": "more please"}]}
              for t, topic in enumerate(TOPICS)]
    with open(cast / "evaluation_topics_v1.0.json", "w") as f:
        json.dump(topics, f)
    with open(cast / "evaluation_topics_annotated_resolved_v1.0.tsv", "w") as f:
        for t, topic in enumerate(TOPICS):
            f.write(f"{31 + t}_1\ttell me about {topic}\n")
            f.write(f"{31 + t}_2\tmore about {topic}\n")
    with open(cast / "2019qrels.txt", "w") as f:
        for t in range(4):
            for i in range(8):
                if i % 4 == t:
                    f.write(f"{31 + t}_1 0 CAR_carpid{i} 2\n")
                    if i != 7:
                        f.write(f"{31 + t}_1 0 MARCO_{i} 1\n")
    from convdr_tpu.core.loading import load_model_and_params
    from convdr_tpu.models.import_torch import export_ance_checkpoint

    init = work / "init"
    os.makedirs(init)
    cfg, tok, _model, params = load_model_and_params("rdot_nll", None, arch_preset="tiny")
    export_ance_checkpoint(jax.tree.map(np.asarray, params), cfg, str(init / "pytorch_model.bin"))
    tok.save_pretrained(str(init))
    return work


def run_chain(raw, name):
    etl, tokenize, train, embed, infer, device_flag = PACKAGES[name]
    work = raw / name
    data, coll = work / "datasets", work / "collections"
    etl.main(["--car_cbor", str(raw / "car.cbor"), "--msmarco_collection",
              str(raw / "marco.tsv"), "--duplicate_file", str(raw / "dup.txt"),
              "--cast_dir", str(raw / "cast"), "--out_data_dir", str(data),
              "--out_collection_dir", str(coll)])
    os.symlink(coll / "collection.tsv", data / "collection.tsv")
    count = tokenize.main(["--collection", str(coll / "collection.tsv"),
                           "--out_data_dir", str(work / "processed"),
                           "--model_type", "rdot_nll", "--max_seq_length", "32",
                           "--num_workers", "1"])
    train.main(["--output_dir", str(work / "model"), "--model_type", "rdot_nll",
                "--teacher_model", str(raw / "init"),
                "--model_name_or_path", str(raw / "init"),
                "--train_file", str(data / "eval_topics.jsonl"), "--query", "no_res",
                "--per_gpu_train_batch_size", "1", "--num_train_epochs", "1",
                "--max_concat_length", "48", "--max_query_length", "16",
                "--arch_size", "tiny", "--learning_rate", "1e-4", *device_flag])
    embed.main(["--data_dir", str(work / "processed"), "--checkpoint", str(work / "model"),
                "--output_dir", str(work / "embeddings"), "--model_type", "rdot_nll",
                "--per_gpu_eval_batch_size", "8", "--dtype", "float32", "--arch_size", "tiny",
                *device_flag])
    metrics = infer.main(["--model_path", str(work / "model"),
                          "--eval_file", str(data / "eval_topics.jsonl"),
                          "--model_type", "rdot_nll", "--ann_data_dir", str(work / "embeddings"),
                          "--processed_data_dir", str(work / "processed"),
                          "--raw_data_dir", str(data), "--qrels", str(data / "qrels.tsv"),
                          "--output_trec_file", str(work / "run.trec"),
                          "--output_query_type", "raw", "--top_n", "10",
                          "--max_concat_length", "48", "--arch_size", "tiny", *device_flag])
    return count, metrics


@pytest.fixture(scope="module")
def chains(raw):
    return {name: run_chain(raw, name) for name in PACKAGES}


def test_etl_and_token_caches_byte_identical(raw, chains):
    assert chains["torch"][0] == chains["jax"][0] == 15  # 8 CAR + 8 MARCO - 1 duplicate
    for sub in ("datasets", "collections", "processed"):
        names = sorted(os.listdir(raw / "torch" / sub))
        assert names == sorted(os.listdir(raw / "jax" / sub)) and names
        for n in names:
            assert ((raw / "torch" / sub / n).read_bytes()
                    == (raw / "jax" / sub / n).read_bytes()), (sub, n)


def test_trec_run_equals_the_jax_chain(raw, chains):
    run = (raw / "torch" / "run.trec").read_bytes()
    assert run == (raw / "jax" / "run.trec").read_bytes()
    assert chains["torch"][1] == chains["jax"][1]
    assert "ndcg_cut_3" in chains["torch"][1] and "recall_10" in chains["torch"][1]
    pids = {int(line.split()[2]) for line in run.decode().splitlines()}
    assert any(p >= 10_000_000 for p in pids) and any(p < 8 for p in pids)
    assert len(run.decode().splitlines()) == 8 * 10


def test_port_run_is_the_exact_search_of_its_blocks(raw, chains):
    """The port's run ranks every turn as an exact numpy search of its own
    blocks with its own query encoder does (top-10 sets)."""
    from convdr_torch.data.token_cache import load_offset2pid

    work = raw / "torch"
    args = t_infer.get_arguments([
        "--model_path", str(work / "model"),
        "--eval_file", str(work / "datasets" / "eval_topics.jsonl"),
        "--model_type", "rdot_nll", "--ann_data_dir", str(work / "embeddings"),
        "--processed_data_dir", str(work / "processed"),
        "--raw_data_dir", str(work / "datasets"), "--output_query_type", "raw",
        "--max_concat_length", "48", "--arch_size", "tiny", "--no_cuda",
    ])
    import torch

    qids, q_embs, _raw = t_infer.encode_queries(args, str(work / "model"), args.eval_file,
                                                torch.float32, torch.device("cpu"))
    rows, rowids = [], []
    for _b, emb, offs in iter_embedding_blocks(str(work / "embeddings")):
        rows.append(np.asarray(emb, np.float32))
        rowids.append(np.asarray(offs, np.int64))
    corpus, rowids = np.concatenate(rows), np.concatenate(rowids)
    offset2pid = load_offset2pid(str(work / "processed"))
    scores = q_embs.astype(np.float32) @ corpus.T
    run = parse_trec_run(str(work / "run.trec"))
    for r, qid in enumerate(qids):
        want = {offset2pid[int(o)] for o in rowids[np.argsort(-scores[r], kind="stable")[:10]]}
        assert {pid for pid, _s in run[qid]} == want, qid
