"""The port's meshed drivers and its multi-chip dry run on the CPU.

``run_convdr_inference`` over two gloo ranks (the ranks' ``WORLD_SIZE``
makes it form its ``("index",)`` mesh: a data-parallel query encode and
the blocks' rows sharded for the search) writes, from rank 0, the TREC run
and the OpenMatch file byte-identical to the unmeshed run's and returns its
metrics; with ``--pq_dir`` (codes sharded) its TREC run is byte-identical
too, and with ``--ivf_dir --nprobe 999`` (sub-lists sharded, every one
probed) each query's top pids are the unmeshed run's, scores within 1e-6
(ties may order by shard); ``gen_passage_embeddings`` over two ranks (a
``("data",)`` mesh, the batch doubled) writes the unmeshed run's rows, the
same set of offsets, within 1e-5. The mirror of ``tests/test_multichip.py``'s driver
test. ``run_convdr_train`` over two ranks (a ``("data",)`` mesh, 2 examples
a rank, each rank tokenizing only its rows) logs the losses and grad norms
of the unmeshed run on the same 4-example global batches (within 5e-6
absolute, the norms 1e-6 relative), one long positive document giving the
ranks' slices different length rungs. ``dryrun_multichip(2)`` and ``(8)``
run the JAX dry run's checks and print its one-line summary.
"""

import json
import os

import numpy as np
import pytest

from convdr_torch.drivers import (
    build_ivf_index,
    gen_passage_embeddings,
    run_convdr_inference,
    run_convdr_train,
    tokenize_collection,
)
from convdr_torch.parallel.dryrun import dryrun_multichip, run_cases, spawn
from convdr_torch.retrieval.blocks import load_embedding_block
from test_torch_train_loop import write_topics


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    raw = tmp / "raw"
    os.makedirs(raw)
    topics = ["cats", "dogs", "birds"]
    with open(raw / "collection.tsv", "w") as f:
        for pid in range(30):
            f.write(f"{pid}\tall about {topics[pid % 3]} number {pid} and more words {pid * 7}\n")
    with open(raw / "queries.raw.tsv", "w") as f, open(raw / "eval_topics.jsonl", "w") as g:
        for t, topic in enumerate(topics):
            for turn in (1, 2):
                f.write(f"{t + 1}_{turn}\ttell me about {topic} {turn}\n")
                g.write(json.dumps({
                    "topic_number": t + 1, "query_number": turn,
                    "input": [f"tell me about {topic}"] * turn,
                    "target": f"tell me about {topic} {turn}"}) + "\n")
    with open(raw / "qrels.tsv", "w") as f:
        for t in range(3):
            for pid in range(t, 30, 3):
                f.write(f"{t + 1}_1\t0\t{pid}\t1\n{t + 1}_2\t0\t{pid}\t1\n")
    tokenize_collection.main([
        "--collection", str(raw / "collection.tsv"), "--out_data_dir", str(tmp / "processed"),
        "--model_type", "rdot_nll", "--max_seq_length", "32", "--num_workers", "1"])
    return tmp


def _embed_argv(tmp, out):
    return ["--data_dir", str(tmp / "processed"), "--checkpoint", "init",
            "--model_type", "rdot_nll", "--output_dir", str(tmp / out),
            "--per_gpu_eval_batch_size", "4", "--dtype", "float32", "--arch_size", "tiny",
            "--no_cuda"]


def _infer_argv(tmp, run):
    return ["--model_path", "init", "--eval_file", str(tmp / "raw" / "eval_topics.jsonl"),
            "--model_type", "rdot_nll", "--ann_data_dir", str(tmp / "emb"),
            "--processed_data_dir", str(tmp / "processed"), "--raw_data_dir", str(tmp / "raw"),
            "--qrels", str(tmp / "raw" / "qrels.tsv"),
            "--output_trec_file", str(tmp / f"{run}.trec"),
            "--output_file", str(tmp / f"{run}.jsonl"), "--output_query_type", "raw",
            "--top_n", "7", "--max_concat_length", "48", "--per_gpu_eval_batch_size", "3",
            "--arch_size", "tiny", "--no_cuda"]


def _train_argv(tmp, out, batch):
    return ["--output_dir", str(tmp / out), "--model_name_or_path", "init",
            "--train_file", str(tmp / "train.jsonl"), "--model_type", "rdot_nll",
            "--query", "no_res", "--ranking_task", "--num_negatives", "3",
            "--per_gpu_train_batch_size", str(batch), "--max_concat_length", "64",
            "--max_doc_length", "512", "--max_steps", "3", "--learning_rate", "1e-3",
            "--arch_size", "tiny", "--no_cuda"]


def _write_train_topics(tmp):
    """8 examples, 6 negatives each; the first positive runs past the
    64-token rung."""
    path = write_topics(tmp / "train.jsonl", 8, n_negs=6)
    lines = [json.loads(line) for line in open(path)]
    lines[0]["doc_pos"] = "title[SEP]" + " ".join(["jazz music in new orleans"] * 20)
    with open(path, "w") as f:
        f.writelines(json.dumps(line) + "\n" for line in lines)


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


ANN = {"pq": ["--pq_dir", "pq"], "ivf": ["--ivf_dir", "ivf", "--nprobe", "999"]}


def _ann_argv(tmp, kind, run):
    flag, name, *rest = ANN[kind]
    return _infer_argv(tmp, run) + [flag, str(tmp / name), *rest]


@pytest.fixture(scope="module")
def runs(corpus):
    """The unmeshed chain, then both drivers over two ranks (the meshed
    inference searches the unmeshed embed's blocks and indexes)."""
    gen_passage_embeddings.main(_embed_argv(corpus, "emb"))
    single = run_convdr_inference.main(_infer_argv(corpus, "single"))
    for name, flags in (("pq", ["--index_type", "pq", "--pq_m", "8", "--pq_nbits", "4",
                                "--pack_codes"]), ("ivf", ["--nlist", "4"])):
        build_ivf_index.main(["--ann_data_dir", str(corpus / "emb"), "--index_dir",
                              str(corpus / name), *flags, "--no_cuda"])
        run_convdr_inference.main(_ann_argv(corpus, name, f"single_{name}"))
    _write_train_topics(corpus)
    run_convdr_train.main(_train_argv(corpus, "train_single", 4))
    cases = {"train": ("driver", dict(module="run_convdr_train",
                                      argv=_train_argv(corpus, "train_mesh", 2))),
             "embed": ("driver", dict(module="gen_passage_embeddings",
                                      argv=_embed_argv(corpus, "emb_mesh"))),
             "infer": ("driver", dict(module="run_convdr_inference",
                                      argv=_infer_argv(corpus, "mesh")))}
    for name in ANN:
        cases[f"infer_{name}"] = ("driver", dict(module="run_convdr_inference",
                                                 argv=_ann_argv(corpus, name, f"mesh_{name}")))
    spawn(2, run_cases, (cases, str(corpus / "ranks.npz")))
    with np.load(corpus / "ranks.npz") as f:
        return single, dict(f)


def test_meshed_inference_writes_the_unmeshed_run(corpus, runs):
    single, got = runs
    for ext in ("trec", "jsonl"):
        with open(corpus / f"single.{ext}", "rb") as a, open(corpus / f"mesh.{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    assert single["mrr"] > 0
    for key, value in single.items():
        assert float(got[f"infer.metric.{key}"]) == value, key


def _trec(path):
    """qid -> [(pid, score)] in rank order."""
    out = {}
    for line in open(path):
        qid, _, pid, _rank, score, _tag = line.split()
        out.setdefault(qid, []).append((pid, float(score)))
    return out


def test_meshed_pq_and_ivf_searches_write_the_unmeshed_runs(corpus, runs):
    with open(corpus / "single_pq.trec", "rb") as a, open(corpus / "mesh_pq.trec", "rb") as b:
        assert a.read() == b.read()
    want, got = _trec(corpus / "single_ivf.trec"), _trec(corpus / "mesh_ivf.trec")
    assert got.keys() == want.keys()
    for qid, ranked in want.items():
        assert {p for p, _ in got[qid]} == {p for p, _ in ranked}, qid
        np.testing.assert_allclose([s for _, s in got[qid]], [s for _, s in ranked], rtol=1e-6)


def test_meshed_embed_writes_the_unmeshed_rows(corpus, runs):
    rows, offsets = load_embedding_block(str(corpus / "emb_mesh"), 0)
    want_rows, want_offsets = load_embedding_block(str(corpus / "emb"), 0)
    assert sorted(offsets.tolist()) == sorted(want_offsets.tolist())
    order, want_order = np.argsort(offsets), np.argsort(want_offsets)
    np.testing.assert_allclose(rows[order], want_rows[want_order], atol=1e-5, rtol=0)


def test_meshed_train_logs_the_unmeshed_losses(corpus, runs):
    want = _metrics(corpus / "train_single" / "metrics.jsonl")
    got = _metrics(corpus / "train_mesh" / "metrics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for row, want_row in zip(got, want):
        assert row.keys() == want_row.keys()
        for key in ("loss", "mse_loss", "ranking_loss"):
            np.testing.assert_allclose(row[key], want_row[key], atol=5e-6, rtol=0, err_msg=key)
        np.testing.assert_allclose(row["grad_norm"], want_row["grad_norm"], rtol=1e-6, atol=0)
    assert sorted(os.listdir(corpus / "train_mesh")) == sorted(
        os.listdir(corpus / "train_single"))


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip(n, capfd):
    dryrun_multichip(n)
    out = capfd.readouterr().out
    assert f"dryrun_multichip({n}): train step loss=" in out
    assert out.rstrip().endswith(
        "sharded search ok, sharded packed-pq4 search ok, sharded IVF probe ok, "
        "refine smoke ok")
