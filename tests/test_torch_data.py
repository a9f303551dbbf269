"""convdr_torch's data, metrics and run-writer layers held against the JAX
package's on the same inputs (CPU). These layers are copies; the tests pin
that the copies stay byte-for-byte equivalent, and that the byte-BPE
pre-tokenizer gives the same pieces with stdlib ``re`` as with ``regex``."""

import json
import os

import numpy as np
import pytest

from convdr_torch.data import tokenizers as torch_tok
from convdr_tpu.data import tokenizers as jax_tok

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BPE_DIR = os.path.join(FIXTURES, "bpe_realistic")
WP_DIR = os.path.join(FIXTURES, "wordpiece_realistic")

TEXTS = [
    "she'd've said they're можете can't won't y'all's",
    "it's the teacher's students' embeddings",
    "the retriever retrieved retrievable passages for questioning",
    "café naïve façade Zürich São Paulo 北京 上海 東京 😀🚀",
    "ça va? ¡hola! ¿qué tal? ärger über größe",
    "38,000,000 documents; top-100 @ 0.466!!! (exactly)",
    "a+b=c, x[0], y{1}, z<2>, w|3, v\\4, u/5",
    " leading space", "trailing space ", "a  b   c\t\td\ne", "",
    "antidisestablishmentarianism tokenizationalizing",
    "q", "ø", " nbsp here", "ℵ∞≠∑",
    # where stdlib \s and Unicode White_Space differ, and numbers that are
    # not decimal digits (superscripts, fractions, roman numerals)
    "x\x1cy\x1dz\x1e\x1f w", "12³ ½ Ⅻ x² ⁴2", "a b　c​d\xa0e",
    "combining é marks कि", "tab\t \n\n  end  ",
]


@pytest.fixture(scope="module")
def fallback_pattern():
    return torch_tok.bpe_pattern(use_regex=False)


@pytest.mark.parametrize("text", TEXTS)
def test_bpe_pattern_without_regex_matches_regex(text, fallback_pattern):
    assert fallback_pattern.findall(text) == torch_tok.bpe_pattern(True).findall(text)


@pytest.mark.parametrize("use_regex", [True, False])
def test_byte_bpe_matches_jax_tokenizer(use_regex, fallback_pattern, monkeypatch):
    if not use_regex:
        monkeypatch.setattr(torch_tok, "bpe_pattern", lambda: fallback_pattern)
    ours = torch_tok.ByteLevelBPETokenizer.from_pretrained(BPE_DIR)
    ref = jax_tok.ByteLevelBPETokenizer.from_pretrained(BPE_DIR)
    for text in TEXTS:
        assert ours.tokenize(text) == ref.tokenize(text), text
        assert ours.encode(text, max_length=16) == ref.encode(text, max_length=16)
    for a, b in zip(TEXTS, TEXTS[1:]):
        assert ours.encode(a, text_pair=b, max_length=24) == ref.encode(
            a, text_pair=b, max_length=24
        )


def test_wordpiece_matches_jax_tokenizer():
    ours = torch_tok.WordPieceTokenizer.from_pretrained(WP_DIR)
    ref = jax_tok.WordPieceTokenizer.from_pretrained(WP_DIR)
    for text in TEXTS:
        assert ours.encode(text) == ref.encode(text), text


def test_token_cache_cross_reads(tmp_path):
    from convdr_torch.data import token_cache as tc_torch
    from convdr_tpu.data import token_cache as tc_jax

    rng = np.random.RandomState(0)
    rows = [rng.randint(0, 500, size=rng.randint(1, 20)) for _ in range(7)]
    for name, writer_mod, reader_mod in (
        ("a", tc_torch, tc_jax), ("b", tc_jax, tc_torch),
    ):
        base = str(tmp_path / name)
        with writer_mod.TokenCacheWriter(base, 16) as w:
            for r in rows:
                w.write(r)
        ids, lens = reader_mod.TokenCache(base).slice(0, 7)
        ref_ids, ref_lens = writer_mod.TokenCache(base).slice(0, 7)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(lens, [min(len(r), 16) for r in rows])
    tc_torch.save_id_maps(str(tmp_path), [5, 9, 2])
    assert tc_jax.load_offset2pid(str(tmp_path)) == [5, 9, 2]


@pytest.mark.parametrize("query_mode", ["no_res", "man_can", "raw", "target"])
@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
def test_conv_dataset_matches_jax(tmp_path, query_mode, model_type):
    from convdr_torch.data.conv_dataset import RESPONSE_TOKEN, ConvSearchDataset
    from convdr_tpu.data.conv_dataset import ConvSearchDataset as JaxDataset

    path = tmp_path / "topics.jsonl"
    with open(path, "w") as f:
        for t in range(3):
            f.write(json.dumps({
                "topic_number": t, "query_number": 2,
                "input": [f"what is topic {t}?", "tell me more about it"],
                "target": f"tell me more about topic {t}",
                "manual_response": ["first answer", f"second answer {t}"],
            }) + "\n")
    kind = "roberta" if model_type == "rdot_nll" else "bert"
    batches = []
    for mod, dataset_cls in ((torch_tok, ConvSearchDataset), (jax_tok, JaxDataset)):
        tok = mod.load_tokenizer(kind, "tiny")
        tok.add_tokens([RESPONSE_TOKEN])
        ds = dataset_cls(
            [str(path)], tok, query_mode=query_mode, model_type=model_type,
            max_concat_length=48, max_query_length=16, mode="inference",
        )
        batches.append(next(ds.batches(8)))
    ours, ref = batches
    assert ours["qid"] == ref["qid"]
    np.testing.assert_array_equal(ours["concat_ids"], ref["concat_ids"])
    np.testing.assert_array_equal(ours["concat_mask"], ref["concat_mask"])
    assert ours["history_utterances"] == ref["history_utterances"]


def test_metrics_golden_fixture():
    from convdr_torch.data.collection import load_qrels
    from convdr_torch.evaluation.metrics import evaluate_run, mean_metrics, parse_trec_run

    fdir = os.path.join(FIXTURES, "metrics_golden")
    run = parse_trec_run(os.path.join(fdir, "run.trec"))
    qrels = load_qrels(os.path.join(fdir, "qrels.tsv"))
    with open(os.path.join(fdir, "expected.json")) as f:
        expected = json.load(f)
    per_q = evaluate_run(run, qrels, ndcg_cuts=(3,), recall_cuts=(2, 100))
    assert set(per_q) == set(expected["per_query"])
    for qid, wants in expected["per_query"].items():
        for metric, want in wants.items():
            assert abs(per_q[qid][metric] - want) < 1e-12, (qid, metric)
    means = mean_metrics(per_q)
    for metric, want in expected["mean"].items():
        assert abs(means[metric] - want) < 1e-12, metric


def test_run_writer_matches_jax(tmp_path):
    from convdr_torch.data.collection import Collection
    from convdr_torch.retrieval.run_writer import write_run_outputs
    from convdr_tpu.retrieval.run_writer import write_run_outputs as jax_write

    scores = np.asarray([[3.0, 2.0, 2.0, 1.0], [5.0, 4.0, -1.0, -2.0]], np.float32)
    offsets = np.asarray([[0, 2, 1, 3], [3, 3, -1, 0]])  # dup pid, -1 slot
    offset2pid = [10, 11, 12, 10]
    kw = dict(
        queries={"q1": "first", "q2": "second"},
        collection=Collection({10: "ten", 11: "eleven", 12: "twelve"}),
        qrels={"q1": {11: 1}},
        raw_sequences={"q1": ["a", "b"]},
    )
    runs = []
    for name, fn in (("ours", write_run_outputs), ("ref", jax_write)):
        runs.append(fn(
            ["q1", "q2"], scores, offsets, offset2pid, 3,
            output_trec_file=str(tmp_path / f"{name}.trec"),
            output_file=str(tmp_path / f"{name}.jsonl"), **kw,
        ))
    assert runs[0] == runs[1]
    for ext in ("trec", "jsonl"):
        assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()
