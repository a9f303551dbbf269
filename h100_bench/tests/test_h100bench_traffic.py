"""The traffic generator: deterministic for a seed, sizes fixed by the mix,
the parameters of each mix and ConvDR's id layout."""

import json
import os

import numpy as np
import pytest

from h100_bench import harness, traffic

MIXES = os.path.join(harness.BENCH, "mixes")
CONFIGS = os.path.join(harness.BENCH, "configs")


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ance():
    return load(os.path.join(CONFIGS, "ance-cast.json"))


@pytest.fixture(scope="module")
def dpr():
    return load(os.path.join(CONFIGS, "dpr-orquac.json"))


def small(mix, **kw):
    return dict(mix, **kw)


@pytest.mark.parametrize("mix_name,cfg_name", [("serve-turns", "ance-cast"),
                                               ("batch-eval", "dpr-orquac")])
def test_queries_deterministic_and_sized_by_the_mix(mix_name, cfg_name):
    cfg = load(os.path.join(CONFIGS, cfg_name + ".json"))
    mix = small(load(os.path.join(MIXES, mix_name + ".json")), pool_queries=300)
    a = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"], 2 ** 31 + 5)
    b = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"], 2 ** 31 + 5)
    c = traffic.conversation_queries(mix, cfg["layout"], cfg["max_concat_length"], 2 ** 31 + 6)
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.mask, b.mask)
    assert not np.array_equal(a.ids, c.ids)
    assert a.ids.shape == (300, cfg["max_concat_length"])
    # every seed serves the same set of sizes, in its own order
    assert sorted(a.valid.tolist()) == sorted(c.valid.tolist())
    assert not np.array_equal(a.valid, c.valid)
    assert len(set(a.valid.tolist())) > 10  # lengths are drawn, not fixed


def test_session_sizes_follow_the_parameters():
    mix = {"turns_per_session": [8, 12], "question_tokens": [6, 18]}
    sessions = traffic.session_sizes(mix, 5000, traffic.rng(3))
    turns = np.array([len(s) for s in sessions[:-1]])
    lengths = np.concatenate(sessions)
    assert turns.min() >= 8 and turns.max() <= 12 and set(turns) == set(range(8, 13))
    assert lengths.min() >= 6 and lengths.max() <= 18
    assert sum(len(s) for s in sessions) == 5000


def test_roberta_layout_matches_concat_conversation_ids(ance):
    layout = ance["layout"]
    qs = [np.array([10, 11]), np.array([12])]
    assert traffic.conversation_ids(qs, layout) == [0, 10, 11, 2, 0, 12, 2]
    row, mask = traffic.pad_row(traffic.conversation_ids(qs, layout), 10, layout["pad_id"])
    assert row.tolist() == [0, 10, 11, 2, 0, 12, 2, 0, 0, 0]
    assert mask.tolist() == [1] * 7 + [0] * 3
    row, mask = traffic.pad_row(list(range(20)), 10, 0)
    assert row.tolist() == list(range(10)) and mask.all()


def test_bert_layout(dpr):
    layout = dpr["layout"]
    qs = [np.array([2000, 2001]), np.array([3000])]
    assert traffic.conversation_ids(qs, layout) == [101, 2000, 2001, 102, 3000, 102]
    assert traffic.sentence_ids(np.array([5000]), layout) == [101, 5000, 102]


@pytest.mark.parametrize("cfg_name", ["ance-cast", "dpr-orquac"])
def test_token_ids_leave_out_the_specials(cfg_name):
    cfg = load(os.path.join(CONFIGS, cfg_name + ".json"))
    layout = cfg["layout"]
    ids = traffic.draw_tokens(traffic.rng(1), 100000, layout)
    assert ids.min() >= layout["token_ids"][0] and ids.max() < layout["token_ids"][1]
    assert ids.max() < cfg["vocab_size"]
    for special in (layout["cls_id"], layout["sep_id"], cfg["pad_token_id"]):
        assert special not in set(ids.tolist())


def test_turn_k_carries_the_k_questions_so_far(ance):
    mix = small(load(os.path.join(MIXES, "serve-turns.json")), pool_queries=40)
    q = traffic.conversation_queries(mix, ance["layout"], 256, 9)
    # within a session the valid length grows turn by turn, each row a
    # prefix of the next
    grows = [(a, b) for a, b in zip(range(39), range(1, 40)) if q.valid[b] > q.valid[a]]
    assert grows
    for a, b in grows:
        n = q.valid[a]
        assert np.array_equal(q.ids[a, :n], q.ids[b, :n])


def test_train_batches(ance):
    mix = small(load(os.path.join(MIXES, "train-kd-rank.json")), pool_steps=3)
    a = traffic.train_batches(mix, ance["layout"], 2 ** 33 + 1)
    b = traffic.train_batches(mix, ance["layout"], 2 ** 33 + 1)
    assert len(a) == 3
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    first = a[0]
    assert first["concat_ids"].shape == (4, 256)
    assert first["target_ids"].shape == (4, 64)
    assert first["doc_ids"].shape == (4, 10, 512)
    target = first["target_mask"].sum(1)
    assert target.min() >= 8 + 2 and target.max() <= 24 + 2
    docs = np.concatenate([x["doc_mask"].sum(-1).ravel() for x in a])
    assert docs.min() >= 16 + 2 and docs.max() <= 512
    assert 60 <= np.median(docs) <= 110  # the law's median of 80 tokens, specials added
    # the rows of the checked steps all differ
    assert len({x["concat_ids"][i].tobytes() for x in a for i in range(4)}) == 12


def test_lognormal_law_is_clipped():
    law = {"law": "lognormal", "median": 80, "sigma": 0.6, "min": 16, "max": 512}
    n = traffic.doc_lengths(law, 20000, traffic.rng(0))
    assert n.min() >= 16 and n.max() <= 512
    assert abs(np.median(n) - 80) <= 3
