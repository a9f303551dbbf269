"""The port's ANCE process fns (convdr_torch/data/process_fns.py), QA
answer matching (convdr_torch/evaluation/qa_eval.py) and small utilities
(convdr_torch/utils/misc.py) against the JAX package's, on the inputs that
``tests/test_parity_extras.py`` and ``tests/test_misc_utils.py`` build and
on seeded ones: equal outputs (arrays bit for bit, tolerance 0)."""

import json
import os

import numpy as np
import pytest

from convdr_torch.data import process_fns as tpf
from convdr_torch.data.token_cache import TokenCache as TCache
from convdr_torch.data.token_cache import TokenCacheWriter as TWriter
from convdr_torch.data.tokenizers import ByteLevelBPETokenizer as TBpe
from convdr_torch.data.tokenizers import WordPieceTokenizer as TWordPiece
from convdr_torch.evaluation import qa_eval as tqa
from convdr_torch.utils import misc as tmisc
from convdr_tpu.data import process_fns as jpf
from convdr_tpu.data.token_cache import TokenCache as JCache
from convdr_tpu.data.token_cache import TokenCacheWriter as JWriter
from convdr_tpu.data.tokenizers import ByteLevelBPETokenizer as JBpe
from convdr_tpu.data.tokenizers import WordPieceTokenizer as JWordPiece
from convdr_tpu.evaluation import qa_eval as jqa
from convdr_tpu.utils import misc as jmisc

LINES = {
    "dual": ["42\tsome passage text", "7\t  padded words here and there  ", "9\t"],
    "triple": ["query\tpositive doc\tnegative doc", "q\tpos\tneg",
               "a long query with many words in it\tp\tn n n n n n n n n n n n n"],
}


def same_rows(a, b):
    """Nested rows of arrays and ints, equal element for element."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (a, b)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_rows(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("tok", ["bpe", "wordpiece"])
@pytest.mark.parametrize("fn,kind", [("dual_process_fn", "dual"),
                                     ("triple_process_fn", "triple"),
                                     ("triple2dual_process_fn", "triple")])
@pytest.mark.parametrize("max_len", [8, 16])
def test_process_fns_match_jax(tok, fn, kind, max_len):
    toks = {"bpe": (TBpe.tiny(), JBpe.tiny()), "wordpiece": (TWordPiece.tiny(), JWordPiece.tiny())}
    ours, theirs = toks[tok]
    for i, line in enumerate(LINES[kind]):
        same_rows(getattr(tpf, fn)(line, i, ours, max_len),
                  getattr(jpf, fn)(line, i, theirs, max_len))


@pytest.mark.parametrize("fn,line", [("dual_process_fn", "only one cell"),
                                     ("triple_process_fn", "a\tb"),
                                     ("triple2dual_process_fn", "a\tb\tc\td")])
def test_process_fns_refuse_bad_lines_alike(fn, line):
    errors = []
    for mod, tok in ((tpf, TBpe.tiny()), (jpf, JBpe.tiny())):
        with pytest.raises(ValueError) as e:
            getattr(mod, fn)(line, 0, tok, 16)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.fixture()
def caches(tmp_path):
    """The token caches of ``tests/test_parity_extras.py`` (3 queries of
    lengths 2-4, 6 passages of lengths 1-6, max length 8), written by each
    package's writer, plus seeded longer ones."""
    rng = np.random.default_rng(0)
    longer = [rng.integers(3, 500, int(n)).tolist() for n in rng.integers(1, 12, 6)]
    out = {}
    for tag, writer, cache in (("torch", TWriter, TCache), ("jax", JWriter, JCache)):
        qbase, pbase = str(tmp_path / f"{tag}_q"), str(tmp_path / f"{tag}_p")
        with writer(qbase, max_seq_length=8) as w:
            for i in range(3):
                w.write(list(range(1, i + 3)))
        with writer(pbase, max_seq_length=8) as w:
            for i in range(6):
                w.write([100 + i] * (i + 1))
            for ids in longer:  # some longer than the cache: cut to 8
                w.write(ids)
        out[tag] = (cache(qbase), cache(pbase))
    return out


@pytest.mark.parametrize("query", [False, True])
def test_cache_record_features_match_jax(caches, query):
    (tq, tp), (jq, jp) = caches["torch"], caches["jax"]
    ours, theirs = (tq, jq) if query else (tp, jp)
    for i in range(3 if query else 12):
        same_rows(tpf.cache_record_features(ours[i], query=query),
                  jpf.cache_record_features(theirs[i], query=query))


@pytest.mark.parametrize("fn", ["training_pairs_from_caches",
                                "triplet_training_data_from_caches"])
@pytest.mark.parametrize("line", ["1\t0\t2,4", "2\t1\t3,5", "0\t11\t6,7,8,9,10"])
def test_cache_stream_fns_match_jax(caches, fn, line):
    ours = list(getattr(tpf, fn)(line, *caches["torch"]))
    theirs = list(getattr(jpf, fn)(line, *caches["jax"]))
    assert ours
    same_rows(ours, theirs)


QA_CASES = [
    (["the cat"], "I saw the cat yesterday"),
    (["the dog"], "I saw the cat yesterday"),
    (["CAT"], "the cat"),
    (["cat"], None),
    (["café"], "un CAFÉ, s'il vous plaît"),
    (["naïve"], "a naïve answer"),  # NFD on both sides
    (["42"], "Hello, World! 42"),
    (["", "world"], "Hello, World!"),
    (["東京"], "I went to 東京 in May"),
    (["e.g."], "for example, e.g. this"),
]


@pytest.mark.parametrize("answers,text", QA_CASES)
def test_has_answer_matches_jax(answers, text):
    assert tqa.has_answer(answers, text) == jqa.has_answer(answers, text)
    if text is not None:
        assert (tqa.SimpleTokenizer().tokenize(text).words(uncased=True)
                == jqa.SimpleTokenizer().tokenize(text).words(uncased=True))
        assert (tqa.SimpleTokenizer().tokenize(text).words()
                == jqa.SimpleTokenizer().tokenize(text).words())


def test_check_answer_and_hit_at_k_match_jax():
    rng = np.random.default_rng(3)
    words = ["about", "dogs", "the", "cat", "sat", "nothing", "Paris", "is", "big"]
    passages = {i: " ".join(rng.choice(words, 6)) for i in range(20)}
    passages[7] = ("the cat sat", "title")
    for answers in (["cat"], ["Paris is"], ["the cat sat"], ["zebra"]):
        ids = rng.permutation(20).tolist()
        hits = tqa.check_answer(passages, answers, ids)
        assert hits == jqa.check_answer(passages, answers, ids)
        for k in (1, 5, 20):
            assert tqa.hit_at_k(hits, k) == jqa.hit_at_k(hits, k)


def test_qa_eval_names_regex_when_it_is_missing(monkeypatch):
    """Without ``regex`` the tokenizer raises a clear error, not another
    pattern's tokens."""
    import builtins

    real_import = builtins.__import__

    def no_regex(name, *args, **kwargs):
        if name == "regex":
            raise ImportError("No module named 'regex'")
        return real_import(name, *args, **kwargs)

    tqa._token_re.cache_clear()
    monkeypatch.setattr(builtins, "__import__", no_regex)
    try:
        with pytest.raises(ImportError, match="regex"):
            tqa.SimpleTokenizer().tokenize("some text")
    finally:
        monkeypatch.undo()
        tqa._token_re.cache_clear()
    assert tqa.SimpleTokenizer().tokenize("some text").words() == ["some", "text"]


@pytest.mark.parametrize("obj", [{1: {2: 0.5}, "a": {3: 1}}, {}, {(1, 2): {None: [1]}}])
def test_convert_to_string_id_matches_jax(obj):
    assert tmisc.convert_to_string_id(obj) == jmisc.convert_to_string_id(obj)


@pytest.mark.parametrize("path", ["/x/checkpoint-1500", "run2/checkpoint-10", "a7b/final-3x9"])
def test_get_checkpoint_no_matches_jax(path):
    assert tmisc.get_checkpoint_no(path) == jmisc.get_checkpoint_no(path)


def test_get_latest_ann_data_matches_jax(tmp_path):
    assert tmisc.get_latest_ann_data(str(tmp_path / "missing")) == (-1, None, None)
    assert tmisc.get_latest_ann_data(str(tmp_path)) == jmisc.get_latest_ann_data(str(tmp_path))
    for n in (1, 3, 12):
        with open(tmp_path / f"ann_ndcg_{n}", "w") as f:
            json.dump({"ndcg": 0.1 * n}, f)
    os.makedirs(tmp_path / "ann_ndcg_notanumber")
    got = tmisc.get_latest_ann_data(str(tmp_path))
    assert got == jmisc.get_latest_ann_data(str(tmp_path))
    assert got[0] == 12 and got[1].endswith("ann_training_data_12")


def test_input_features_pair_matches_jax():
    kw = dict(input_ids_a=[1, 2], attention_mask_a=[1, 1], input_ids_b=[3], label=1)
    assert (tmisc.InputFeaturesPair(**kw).to_json_string()
            == jmisc.InputFeaturesPair(**kw).to_json_string())
    assert (tmisc.InputFeaturesPair(input_ids_a=[]).to_json_string()
            == jmisc.InputFeaturesPair(input_ids_a=[]).to_json_string())
