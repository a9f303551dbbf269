"""The port's ranking-data ETL and fold helpers against the JAX package's
on inputs made from a seed: with the same ``--seed`` both write the same
bytes (the main file and, with ``--cast``, every fold file)."""

import json
import os

import numpy as np
import pytest

from convdr_torch.etl import common as tcommon
from convdr_torch.etl import ranking_data as tranking
from convdr_tpu.etl import common as jcommon
from convdr_tpu.etl import ranking_data as jranking


def write_inputs(work, seed):
    """Topics (CAsT ids, 7 topics x 3 turns, fold files for 5 of them),
    a 300-passage collection, qrels with graded positives and judged
    negatives, and a 60-deep run per query."""
    rng = np.random.RandomState(seed)
    topics = os.path.join(work, "eval_topics.jsonl")
    records = []
    for t in range(1, 8):
        for turn in range(1, 4):
            records.append({"topic_number": t, "query_number": turn,
                            "input": [f"q{t} turn {k}" for k in range(turn)],
                            "target": f"topic {t} turn {turn}"})
    folds = tcommon.contiguous_topic_folds([str(r["topic_number"]) for r in records])
    tcommon.write_topics_with_folds(records, topics, folds)
    collection = os.path.join(work, "collection.tsv")
    with open(collection, "w") as f:
        for pid in range(300):
            f.write(f"{pid}\tpassage {pid} " + "w" * int(rng.randint(1, 9)) + "\n")
    qrels = os.path.join(work, "qrels.tsv")
    run = os.path.join(work, "run.trec")
    with open(qrels, "w") as fq, open(run, "w") as fr:
        for rec in records:
            qid = f"{rec['topic_number']}_{rec['query_number']}"
            if qid == "2_2":
                continue  # judged nowhere: no record
            judged = rng.choice(300, 12, replace=False)
            for i, pid in enumerate(judged):
                rel = [2, 1, 1][i] if i < 3 else 0
                fq.write(f"{qid}\t0\t{pid}\t{rel}\n")
            ranked = list(judged[1:8]) + list(rng.choice(300, 53, replace=False))
            for rank, pid in enumerate(dict.fromkeys(ranked)):
                fr.write(f"{qid} Q0 {pid} {rank + 1} {1.0 / (rank + 1):.6f} run\n")
    return topics, collection, qrels, run


@pytest.mark.parametrize("num_negs", [3, 9, 40])
@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("seed", [13, 5])
def test_ranking_data_byte_identical_to_jax(tmp_path, seed, cast, num_negs):
    topics, collection, qrels, run = write_inputs(str(tmp_path), seed)
    outs = {}
    for name, mod in (("torch", tranking), ("jax", jranking)):
        out = str(tmp_path / f"{name}.rank.jsonl")
        argv = ["--train", topics, "--run", run, "--qrels", qrels, "--output", out,
                "--collection", collection, "--num_negs", str(num_negs),
                "--seed", str(seed)]
        mod.main(argv + (["--cast"] if cast else []))
        outs[name] = out
    data = open(outs["torch"], "rb").read()
    assert data == open(outs["jax"], "rb").read()
    recs = [json.loads(ln) for ln in data.decode().splitlines()]
    assert 0 < len(recs) <= 20 and "2_2" not in {
        f"{r['topic_number']}_{r['query_number']}" for r in recs}
    for r in recs:
        assert len(r["doc_negs"]) == min(num_negs, len(r["doc_negs_id"])) and r["doc_pos"]
    if cast:
        for fold in range(5):
            assert (open(f"{outs['torch']}.{fold}", "rb").read()
                    == open(f"{outs['jax']}.{fold}", "rb").read())


def test_negative_pool_and_qrels_parsing_equal_jax(tmp_path):
    _topics, _collection, qrels, run = write_inputs(str(tmp_path), 21)
    pos_t, neg_t = tranking.parse_qrels_pos_neg(qrels)
    pos_j, neg_j = jranking.parse_qrels_pos_neg(qrels)
    assert (pos_t, neg_t) == (pos_j, neg_j)
    negs = tranking.collect_negatives(run, pos_t, neg_t)
    assert negs == jranking.collect_negatives(run, pos_j, neg_j)
    assert max(len(v) for v in negs.values()) <= tranking.NEGATIVE_POOL_CAP


@pytest.mark.parametrize("n_topics", [3, 10, 12])
def test_fold_helpers_equal_jax(tmp_path, n_topics):
    order = [f"t{i % n_topics}" for i in range(3 * n_topics)]  # repeats: first-seen order
    assert tcommon.contiguous_topic_folds(order) == jcommon.contiguous_topic_folds(order)
    records = [{"topic_number": i, "query_number": 1, "input": ["x"]} for i in range(n_topics)]
    records += [{"qid": 1000 + i, "topic_number": i, "query_number": 2} for i in range(2)]
    folds = {str(i): i % 5 for i in range(n_topics)}
    tcommon.write_topics_with_folds(records, str(tmp_path / "t.jsonl"), folds)
    jcommon.write_topics_with_folds(records, str(tmp_path / "j.jsonl"), folds)
    for suffix in [""] + [f".{k}" for k in range(5)]:
        assert (tmp_path / f"t.jsonl{suffix}").read_bytes() == (
            tmp_path / f"j.jsonl{suffix}").read_bytes()
    assign = tcommon.load_fold_assignment(str(tmp_path / "t.jsonl"))
    assert assign == jcommon.load_fold_assignment(str(tmp_path / "t.jsonl"))
    assert assign["0_1"] == 0 and assign[f"{n_topics - 1}_1"] == (n_topics - 1) % 5


def test_sim_file_and_qrels_remap_equal_jax(tmp_path):
    sim = tmp_path / "dups.txt"
    sim.write_text("MARCO_1:MARCO_2,MARCO_3\nMARCO_4:\nCAR_a:CAR_b\n")
    assert tcommon.parse_sim_file(str(sim)) == jcommon.parse_sim_file(str(sim))
    qrels = tmp_path / "q.txt"
    qrels.write_text("31_1 0 CAR_x 2\n31_1 0 MARCO_0042 1\n31_2 0 OTHER_1 1\n31_2 0 CAR_y 0\n")
    car = {"CAR_x": tcommon.CAR_BASE_ID, "CAR_y": tcommon.CAR_BASE_ID + 1}
    tcommon.remap_qrels(str(qrels), str(tmp_path / "t.tsv"), car)
    jcommon.remap_qrels(str(qrels), str(tmp_path / "j.tsv"), car)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    assert tcommon.CAR_BASE_ID == jcommon.CAR_BASE_ID
