"""The packed encoder path (``models/transformer.py::Packing``) and the
serving front's token index (``retrieval/online.py``), on the CPU.

The packed query embeddings equal the padded path's and the JAX package's
``query_emb`` within the encoder's f32 tolerance (1e-5 absolute, as in
``tests/test_torch_models.py``): ANCE with first-token and masked-mean
pooling, DPR's question tower. Capacity tails of every length leave the
result alone, and rows past the valid tokens filled with NaN or huge
values never reach a returned row. The front packs only prefix-layout
calls whose capacity is below Q * T; a packed ``search_tokens`` call
equals its queries served one at a time; the counter reports the packed
calls and the share of their capacity that valid tokens filled.
"""

import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.models import encoders as tenc
from convdr_torch.models.transformer import EncoderLayer, Packing
from convdr_torch.ops.exact_search import flat_ip_topk
from convdr_torch.ops.fused_search import ROW_TILE
from convdr_torch.retrieval import online
from test_torch_models import (
    ATOL,
    both_models,
    dpr_config,
    jax_emb,
    make_batch,
    tiny_config,
)

MODELS = {
    "ance_first": lambda: tiny_config(),
    "ance_mean": lambda: tiny_config(use_mean=True),
    "dpr": dpr_config,
}


def packing(mask: np.ndarray, extra: int) -> Packing:
    """The front's token index of ``mask`` with ``extra`` sentinel rows."""
    index = np.empty(int(mask.sum()) + extra, np.int64)
    first = np.empty(len(mask), np.int64)
    online.fill_packing(mask, index, first)
    return Packing(torch.from_numpy(index), torch.from_numpy(first))


def query_emb(model, ids, mask, pack=None):
    with torch.no_grad():
        return model.query_emb(torch.from_numpy(ids), torch.from_numpy(mask),
                               packing=pack).numpy()


def tower(model):
    return model.question_model if isinstance(model, tenc.DPRBiEncoder) else model.roberta


@pytest.mark.parametrize("extra", [0, 1, 37])
@pytest.mark.parametrize("name", list(MODELS))
def test_packed_query_emb_matches_padded_and_jax(name, extra):
    """Packed into the valid count plus ``extra`` sentinel rows, the query
    embeddings equal the padded path's and the JAX package's."""
    cfg = MODELS[name]()
    jmodel, params, tmodel = both_models(cfg)
    ids, mask = make_batch(5, b=6, t=16, lengths=[16, 1, 9, 2, 13, 5])
    got = query_emb(tmodel, ids, mask, packing(mask, extra))
    assert got.dtype == np.float32 and got.shape == (6, query_emb(tmodel, ids, mask).shape[1])
    np.testing.assert_allclose(got, query_emb(tmodel, ids, mask), atol=ATOL)
    np.testing.assert_allclose(got, jax_emb(jmodel, params, ids, mask, "query_emb"), atol=ATOL)


@pytest.mark.parametrize("fill", [float("nan"), 1e30])
@pytest.mark.parametrize("name", list(MODELS))
def test_sentinel_rows_never_reach_an_output(name, fill):
    """Rows past the valid tokens overwritten with ``fill`` after the
    embeddings and after every layer: the embeddings stay finite and equal
    to the clean packed run's."""
    _, _, tmodel = both_models(MODELS[name]())
    ids, mask = make_batch(6, b=5, t=16, lengths=[3, 16, 7, 1, 11])
    pack = packing(mask, 29)
    clean = query_emb(tmodel, ids, mask, pack)
    n_valid = int(mask.sum())

    def poison(_module, _inputs, out):
        out[n_valid:] = fill
        return out

    enc = tower(tmodel)
    hooks = [m.register_forward_hook(poison) for m in
             [enc.embeddings, *(m for m in enc.modules() if isinstance(m, EncoderLayer))]]
    try:
        dirty = query_emb(tmodel, ids, mask, pack)
    finally:
        for h in hooks:
            h.remove()
    assert np.isfinite(dirty).all()
    np.testing.assert_array_equal(dirty, clean)


def test_packed_dpr_reads_the_question_tower():
    """The packed DPR query embedding is the question tower's, not the
    context tower's."""
    _, _, tmodel = both_models(dpr_config())
    ids, mask = make_batch(7, b=4, t=16, lengths=[4, 16, 8, 2])
    got = query_emb(tmodel, ids, mask, packing(mask, 3))
    with torch.no_grad():
        body = tmodel.body_emb(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert not np.allclose(got, body, atol=1e-3)


def prefix_mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


@pytest.mark.parametrize("case,q,t,want", [
    ("small_q", 1, 256, None),  # a serving turn: 4,096 >= 256 positions
    ("q512_short", 512, 256, 36864),
    ("q64_full", 64, 256, None),  # every token valid: capacity 16,384 == Q * T
    ("non_prefix", 64, 128, None),
    ("empty_row", 64, 128, None),
    ("q64_short", 64, 128, 4096),
])
def test_packed_capacity_decides_the_path(case, q, t, want):
    """Only prefix-layout calls with a row of at least one token and a
    capacity below Q * T pack; the capacity is the valid count rounded up
    to ``PACK_STEP``."""
    rng = np.random.RandomState(8)
    if case == "q512_short":
        lengths = np.full(q, 67)  # 34,304 valid tokens
    elif case == "q64_full":
        lengths = np.full(q, t)
    else:
        lengths = rng.randint(1, 40, size=q)
    mask = prefix_mask(lengths, t)
    if case == "non_prefix":
        mask[3, 0], mask[3, lengths[3]] = 0, 1  # a left pad: same count, not a prefix
    if case == "empty_row":
        mask[5] = 0
    assert online.packed_capacity(mask) == want


def test_fill_packing_writes_the_index_and_first_rows():
    """The valid tokens' flat positions in order, then the sentinel Q * T;
    each row's first token among the packed rows."""
    mask = prefix_mask([2, 4, 1], 5)
    index, first = np.empty(9, np.int64), np.empty(3, np.int64)
    assert online.fill_packing(mask, index, first) == 7
    np.testing.assert_array_equal(index, [0, 1, 5, 6, 7, 8, 10, 15, 15])
    np.testing.assert_array_equal(first, [0, 2, 6])


def cpu_searcher(t=128, top_n=10, rows=300):
    """An ``OnlineSearcher`` on the CPU over a seeded flat f32 corpus, with
    a tiny ANCE model."""
    torch.manual_seed(0)
    cfg = tcfg.ModelConfig(name="test", arch=tcfg.EncoderArchConfig.tiny(vocab_size=64),
                           embedding_dim=24, projection_head=True)
    model = tenc.build_model(cfg).eval()
    g = torch.Generator().manual_seed(1)
    corpus = torch.zeros((-(-rows // ROW_TILE) * ROW_TILE, 24))
    corpus[:rows] = torch.randn((rows, 24), generator=g)

    @torch.inference_mode()
    def search_embeddings(q):
        return flat_ip_topk(q, corpus, top_n, block_rows=corpus.shape[0], valid_rows=rows)

    class Specials:
        cls_token_id = 0

    return online.OnlineSearcher(
        tokenizer=Specials(), model=model, search_embeddings=search_embeddings,
        operands=(corpus,), top_n=top_n, model_type="rdot_nll", max_concat_length=t,
        device=torch.device("cpu"))


def queries(seed, q, t, max_len=40):
    rng = np.random.RandomState(seed)
    mask = prefix_mask(rng.randint(1, max_len, size=q), t)
    ids = rng.randint(4, 64, size=(q, t)).astype(np.int32) * mask + (1 - mask)
    return ids, mask


def test_packed_search_tokens_equals_one_at_a_time():
    """A Q=64 call that packs returns, row for row, what its queries served
    one at a time (Q=1, padded) return: the same rows, scores within the
    encoder's tolerance."""
    searcher = cpu_searcher()
    ids, mask = queries(9, 64, 128)
    assert online.packed_capacity(mask) == online.PACK_STEP
    s, i = searcher.search_tokens(ids, mask)
    assert searcher.packing_stats()["packed_calls"] == 1
    for r in range(len(ids)):
        s1, i1 = searcher.search_tokens(ids[r:r + 1], mask[r:r + 1])
        np.testing.assert_array_equal(i[r], i1[0])
        np.testing.assert_allclose(s[r], s1[0], rtol=1e-5, atol=1e-5)
    stats = searcher.packing_stats()
    assert stats["calls"] == 65 and stats["packed_calls"] == 1


def test_packing_counter_reads_known_masks():
    """Three calls of known masks: two pack (2,300 and 5,000 valid tokens,
    capacities 4,096 and 8,192), one Q=1 turn and one non-prefix call do
    not; the token share is 7,300 / 12,288."""
    searcher = cpu_searcher(top_n=5, rows=64)
    assert searcher.packing_stats() == {"calls": 0, "packed_calls": 0,
                                        "packed_call_share": None, "token_share": None}
    rng = np.random.RandomState(10)
    calls = []
    for lengths in ([23] * 100, [50] * 100):
        mask = prefix_mask(lengths, 128)
        calls.append((rng.randint(4, 64, size=mask.shape).astype(np.int32) * mask, mask))
    turn = prefix_mask([30], 128)
    calls.append((turn * 7, turn))
    skewed = prefix_mask([23] * 100, 128)
    skewed[0, :2] = [0, 1]
    skewed[0, 23] = 1
    calls.append((skewed * 5, skewed))
    for ids, mask in calls:
        searcher.search_tokens(ids, mask, record=False)
    assert searcher.packing_stats() == {"calls": 4, "packed_calls": 2,
                                        "packed_call_share": 0.5,
                                        "token_share": 7300 / 12288}
    assert searcher.stats.latencies == []
