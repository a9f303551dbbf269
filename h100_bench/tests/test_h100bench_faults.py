"""Whole tiny runs on the CPU with the timed path broken underneath: each
fault a cell can have turns ``correct`` false. (The look for a card is the
entry's, which these runs skip.)"""

import pytest
import torch

from convdr_torch.retrieval.online import OnlineSearcher
from h100_bench import program
from h100_bench.tests.tinybench import run_tiny


def failed(res):
    res.pop("_forbidden")
    return not res["correct"] and any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["ance-cast.serve-turns", "dpr-orquac.batch-eval"])
def test_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch, cell):
    real = OnlineSearcher.search_tokens

    def altered(self, ids, mask, **kw):
        s, r = real(self, ids, mask, **kw)
        r = r.copy()
        r[:, 0] = (r[:, 0] + 1) % 5000  # one row of each answer is another row
        return s, r

    monkeypatch.setattr(OnlineSearcher, "search_tokens", altered)
    assert failed(run_tiny(tmp_path, cell))


def test_half_of_the_batch_left_out(tmp_path, monkeypatch):
    """A call that searches half of its queries and answers the rest with
    those answers."""
    real = OnlineSearcher.search_tokens

    def half(self, ids, mask, **kw):
        n = ids.shape[0] // 2
        s, r = real(self, ids[:n], mask[:n], **kw)
        return s.repeat(2, 0)[:ids.shape[0]], r.repeat(2, 0)[:ids.shape[0]]

    monkeypatch.setattr(OnlineSearcher, "search_tokens", half)
    assert failed(run_tiny(tmp_path, "dpr-orquac.batch-eval"))


def broken_trainer(monkeypatch, wrap):
    real = program.train_step

    def patched(*a, **kw):
        state, step_fn, teacher = real(*a, **kw)
        return state, wrap(step_fn), teacher

    monkeypatch.setattr(program, "train_step", patched)


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    def wrap(step_fn):
        def step(state, batch):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            state, metrics = step_fn(state, batch)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(before[n])
            return state, metrics
        return step

    broken_trainer(monkeypatch, wrap)
    res = run_tiny(tmp_path, "ance-cast.train-kd-rank")
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    assert failed(res)


def test_a_step_on_half_of_its_batch(tmp_path, monkeypatch):
    def wrap(step_fn):
        def step(state, batch):
            n = batch["concat_ids"].shape[0] // 2
            return step_fn(state, {k: v[:n] for k, v in batch.items()})
        return step

    broken_trainer(monkeypatch, wrap)
    assert failed(run_tiny(tmp_path, "ance-cast.train-kd-rank"))


def broken_embedder(monkeypatch, wrap_apply):
    from convdr_torch.retrieval import embed_corpus

    real = embed_corpus.generate_embeddings

    def patched(apply_fn, *a, **kw):
        return real(wrap_apply(apply_fn), *a, **kw)

    monkeypatch.setattr(embed_corpus, "generate_embeddings", patched)


def test_an_embedding_altered_where_it_is_produced(tmp_path, monkeypatch):
    def wrap(apply_fn):
        def altered(ids, mask, is_query):
            out = apply_fn(ids, mask, is_query).clone()
            out[0] = -out[0]  # the first row of each batch
            return out
        return altered

    broken_embedder(monkeypatch, wrap)
    assert failed(run_tiny(tmp_path, "ance-cast.embed-passages"))


def test_an_embed_batch_half_left_out(tmp_path, monkeypatch):
    """Each batch encodes half of its rows and writes those embeddings for
    the rest too."""
    def wrap(apply_fn):
        def half(ids, mask, is_query):
            n = ids.shape[0] // 2
            out = apply_fn(ids[:n], mask[:n], is_query)
            return out.repeat(2, 1)[:ids.shape[0]]
        return half

    broken_embedder(monkeypatch, wrap)
    assert failed(run_tiny(tmp_path, "ance-cast.embed-passages"))
