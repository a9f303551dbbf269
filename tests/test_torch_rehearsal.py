"""The port's rehearsal against the JAX package's script (loaded by path, as
tests/test_rehearsal.py does): the raw corpus, topics, qrels and warm-up
ranking files are byte-identical, drawn from the same seeded stream. The
whole ``--smoke`` chain (train 500 steps, then NDCG@3 and MRR must rise)
is slow on the CPU and runs only with RUN_SLOW_REHEARSAL=1, as the JAX
test does; it runs on the card in chip_smoke.py."""

import importlib.util
import os

import numpy as np
import pytest

from convdr_torch.scripts import rehearsal as trh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_rehearsal():
    spec = importlib.util.spec_from_file_location(
        "jax_rehearsal", os.path.join(REPO, "scripts", "rehearsal.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_topics,turns,n_passages,base_words",
                         [(6, 4, 1500, 30), (5, 3, 200, 102)])
def test_raw_files_byte_identical_to_jax_script(tmp_path, n_topics, turns, n_passages,
                                                base_words):
    jrh = jax_rehearsal()
    assert (trh.WORDS, trh.FILLER, trh.OWNED_PER_TOPIC) == (
        jrh.WORDS, jrh.FILLER, jrh.OWNED_PER_TOPIC)
    for name, mod in (("torch", trh), ("jax", jrh)):
        d = tmp_path / name
        os.makedirs(d)
        rng = np.random.RandomState(17)
        topics = [f"{mod.WORDS[rng.randint(len(mod.WORDS))]} "
                  f"{mod.WORDS[rng.randint(len(mod.WORDS))]}" for _ in range(n_topics)]
        mod.make_corpus(str(d / "collection.tsv"), n_passages, topics, rng,
                        base_words=base_words)
        mod.make_topics(str(d / "eval_topics.jsonl"), str(d / "queries.raw.tsv"),
                        topics, turns, rng)
        mod.build_warmup_ranking(str(d / "eval_topics.jsonl"), str(d / "collection.tsv"),
                                 str(d / "warmup_rank.jsonl"), rng)
        # a teacher run with ties of rank order and more than 3 hits a query
        with open(d / "teacher.trec", "w") as f:
            for t in range(n_topics):
                for rank in (3, 1, 2, 4, 5):
                    f.write(f"{t + 1}_1 Q0 {t * 7 + rank} {rank} {1.0 / rank:.4f} ConvDR\n")
        mod.build_qrels_from_run(str(d / "teacher.trec"), str(d / "qrels.tsv"))
    for name in ("collection.tsv", "eval_topics.jsonl", "queries.raw.tsv",
                 "warmup_rank.jsonl", "qrels.tsv"):
        assert (tmp_path / "torch" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


def test_rehearsal_imports_no_torch_at_module_level():
    """``python -m convdr_torch.scripts.rehearsal`` is the main module of
    any worker it spawns; the drivers load inside ``main``."""
    import subprocess
    import sys

    code = ("import sys, convdr_torch.scripts.rehearsal\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.skipif(
    not os.environ.get("RUN_SLOW_REHEARSAL"),
    reason="set RUN_SLOW_REHEARSAL=1 to run the slow CPU rehearsal (the card runs it "
    "in chip_smoke.py)",
)
def test_rehearsal_smoke(tmp_path):
    summary = trh.main(["--workdir", str(tmp_path / "r"), "--smoke", "--no_cuda"])
    assert summary["trained"]["ndcg_cut_3"] > summary["baseline"]["ndcg_cut_3"]
    assert summary["trained"]["mrr"] > summary["baseline"]["mrr"]
    assert summary["oracle_set_mismatches_8q"] == 0


# ---------------- the oracle check's near-tie rule ----------------
def _oracle_blocks():
    """One query, 300 passages in two blocks: f64 scores 1.0 down in steps
    of 1e-3 (the first coordinate; the others are orthogonal noise), with
    ranks 100 and 101 0.1 * tol apart."""
    rng = np.random.RandomState(0)
    q = np.zeros((1, 6), np.float32)
    q[0, 0] = 1.0
    emb = np.zeros((300, 6), np.float32)
    emb[:, 0] = 1.0 - 1e-3 * np.arange(300)
    emb[:, 1:] = rng.randn(300, 5) * 0.1
    pnorm = np.linalg.norm(emb.astype(np.float64), axis=1).max()
    tol = 1e-5 * pnorm
    emb[100, 0] = emb[99, 0] - np.float32(0.1 * tol)  # a near-tie at the cut
    emb[250, 0] = emb[99, 0] - np.float32(100 * tol)  # far below the cut
    ids = np.arange(300, dtype=np.int64) + 1000
    blocks = lambda: iter([(emb[:150], ids[:150]), (emb[150:], ids[150:])])  # noqa: E731
    return q, ids, blocks


@pytest.mark.parametrize("case,want", [("equal", 0), ("near_tie_swap", 0), ("wrong_row", 1),
                                       ("missing_row", 1)])
def test_oracle_mismatches_accepts_only_near_ties(case, want):
    q, ids, blocks = _oracle_blocks()
    top = list(ids[:100])
    if case == "near_tie_swap":  # the searcher keeps rank 101 instead of rank 100
        top[99] = ids[100]
    elif case == "wrong_row":  # a row 100 * tol below the cut instead of rank 100
        top[99] = ids[250]
    elif case == "missing_row":  # rank 100 left out: one id twice
        top[99] = top[0]
    got = np.array([top], np.int64)
    assert trh.oracle_mismatches(q, got, blocks) == want
