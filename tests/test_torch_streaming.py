"""convdr_torch's streaming search and group gather against the JAX package
(CPU).

The JAX Pallas kernels run in interpret mode, as ``tests/test_pallas_search.py``
runs them; the port's CPU tensors take the plain versions. Group maxima and
candidate scores within 1e-5 (f32 sums in another order); the streaming
top-k must give IDENTICAL indices to the JAX streaming search and the numpy
oracle, the gathers equal values. The JAX ``gather="dma"`` route compiles
for the TPU and cannot run here, so the port's ``flat_ip_topk`` (whose
``gather`` selects no code: the card always takes the gather kernel) is held
to the JAX ``gather="auto"``, which computes the same selection.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.ops import exact_search as tes
from convdr_torch.ops import gather_groups as tgg
from convdr_torch.ops import streaming_search as tss
from convdr_torch.ops.quant import Int8Quantizer, int8_topk_oracle
from convdr_tpu.ops import exact_search as jes
from convdr_tpu.ops import pallas_search as jps


def problem(rng, q=4, n=512, d=32):
    return rng.randn(q, d).astype(np.float32), rng.randn(n, d).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("group", [16, 128])
def test_streaming_groupmax_matches_pallas_interpret(rng, group):
    q, p = problem(rng)
    got = tss.streaming_groupmax(t(q), t(p), group)
    want = jps.streaming_groupmax(
        jnp.asarray(q), jnp.asarray(p), group=group, tile_rows=128, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert tss.streaming_groupmax.launches == 0  # CPU: plain version


@pytest.mark.parametrize("group,kg", [(16, 5), (128, 3)])
def test_extract_candidates_matches_pallas_interpret(rng, group, kg):
    q, p = problem(rng, q=8)
    gsel = np.sort(np.stack([
        rng.choice(512 // group, size=kg, replace=False) for _ in range(8)
    ]).astype(np.int32), axis=1)
    got = tss.extract_candidate_scores(t(q), t(p), t(gsel), group)
    want = jps.extract_candidate_scores(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(gsel),
        group=group, tile_rows=128, query_tile=4, interpret=True,
    )
    assert got.shape == (8, kg, group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the plain pass B scores the selected rows as the full matmul does
    full = (t(q) @ t(p).T).numpy()
    np.testing.assert_allclose(
        got.numpy(),
        np.stack([full[r].reshape(-1, group)[gsel[r]] for r in range(8)]),
        atol=1e-5, rtol=0,
    )
    assert tss.extract_candidate_scores.launches == 0


@pytest.mark.parametrize("group,kg", [(16, 5), (128, 3)])
def test_extract_candidates_unchecked_matches_public_and_pallas(rng, group, kg):
    # the entry the streaming search calls (no range check, so no host sync
    # on the card) at the cases of the test above
    q, p = problem(rng, q=8)
    gsel = np.sort(np.stack([
        rng.choice(512 // group, size=kg, replace=False) for _ in range(8)
    ]).astype(np.int32), axis=1)
    got = tss.extract_candidate_scores_unchecked(t(q), t(p), t(gsel), group)
    assert torch.equal(got, tss.extract_candidate_scores(t(q), t(p), t(gsel), group))
    want = jps.extract_candidate_scores(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(gsel),
        group=group, tile_rows=128, query_tile=4, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert tss.extract_candidate_scores.launches == 0


def selections(rng, kind, qn, n_groups, kg):
    """[Q, kg] group ids, ascending in each row: "uniform" (kg distinct
    random groups a query), "one_group" (every query picks one group, and
    kg - 1 others) or "unpicked" (all picks from 3 groups: most have none)."""
    if kind == "uniform":
        rows = [rng.choice(n_groups, size=kg, replace=False) for _ in range(qn)]
    elif kind == "one_group":
        rows = [np.concatenate([[n_groups // 2], rng.choice(
            np.delete(np.arange(n_groups), n_groups // 2), size=kg - 1, replace=False)])
            for _ in range(qn)]
    else:
        pool = rng.choice(n_groups, size=3, replace=False)
        rows = [rng.choice(pool, size=kg) for _ in range(qn)]
    return np.sort(np.stack(rows), axis=1)


@pytest.mark.parametrize("group", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["uniform", "one_group", "unpicked"])
def test_candidate_work_list_covers_every_slot_once(rng, group, kind):
    qn, kg, n_groups = 70, 3, 4096 // group
    gsel = t(selections(rng, kind, qn, n_groups, kg))
    slots, items, n_items = tss.candidate_work_list(gsel, n_groups)
    tm = tss.ITEM_SLOTS
    n = int(n_items[0])
    assert slots.dtype == items.dtype == n_items.dtype == torch.int32
    assert items.shape == (min(n_groups, qn * kg) + qn * kg // tm, 3) and n <= items.shape[0]
    flat = gsel.reshape(-1)
    seen = np.zeros(qn * kg, np.int64)
    by_group = {}
    for i, (g, first, cnt) in enumerate(items[:n].tolist()):
        assert 1 <= cnt <= tm
        ids = slots[first:first + cnt].long()
        assert bool((flat[ids] == g).all())  # an item holds one group's slots
        seen[ids.numpy()] += 1
        by_group.setdefault(g, []).append((i, first, cnt))
    assert (seen == 1).all()  # every slot in exactly one item
    for g, its in by_group.items():
        # one group's items are consecutive, back to back, and cover it
        assert [i for i, _, _ in its] == list(range(its[0][0], its[0][0] + len(its)))
        assert all(a[1] + a[2] == b[1] for a, b in zip(its, its[1:]))
        assert sum(c for _, _, c in its) == int((flat == g).sum())
        assert all(c == tm for _, _, c in its[:-1])
    assert sorted(by_group) == sorted(set(flat.tolist()))  # unpicked groups: no item
    counts = torch.bincount(flat, minlength=n_groups)
    assert n == int(((counts + tm - 1) // tm).sum())


@pytest.mark.parametrize("bad", [-1, 512 // 16])
def test_extract_candidates_rejects_out_of_range_ids(rng, bad):
    q, p = problem(rng, q=3)
    gsel = torch.tensor([[0, 4], [1, bad], [2, 3]], dtype=torch.int32)
    with pytest.raises(IndexError, match="group ids"):
        tss.extract_candidate_scores(t(q), t(p), gsel, 16)


@pytest.mark.parametrize("n,valid", [(640, -1), (600, 555)])
def test_streaming_topk_matches_jax_and_oracle(rng, n, valid):
    q, p = problem(rng, q=6, n=n)
    n_valid = n if valid < 0 else valid
    os_, oi = jes.topk_oracle(q, p[:n_valid], 37)
    s, i = tss.streaming_flat_ip_topk(t(q), t(p), 37, group=16, valid_rows=valid)
    js, ji = jps.streaming_flat_ip_topk(
        jnp.asarray(q), jnp.asarray(p), 37,
        group=16, tile_rows=64, query_tile=2, valid_rows=valid, interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), oi)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)


@pytest.mark.parametrize("group", [16, 128])
def test_streaming_topk_tie_break(group):
    q = np.ones((4, 8), np.float32)
    p = np.zeros((512, 8), np.float32)
    p[[5, 16, 255, 256, 400]] = 1.0
    _, i = tss.streaming_flat_ip_topk(t(q), t(p), 5, group=group)
    assert list(i.numpy()[0]) == [5, 16, 255, 256, 400]
    _, ji = jps.streaming_flat_ip_topk(
        jnp.asarray(q), jnp.asarray(p), 5,
        group=16, tile_rows=64, query_tile=4, interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,k", [(64, 80), (200, 300)])
def test_streaming_topk_k_exceeds_n(rng, n, k):
    q, p = problem(rng, q=2, n=n, d=8)
    s, i = tss.streaming_flat_ip_topk(t(q), t(p), k, group=32)
    os_, oi = jes.topk_oracle(q, p, k)
    np.testing.assert_array_equal(i.numpy(), oi)
    assert (i.numpy()[:, n:] == -1).all() and (s.numpy()[:, n:] == tes.NEG_INF).all()
    _, ji = jps.streaming_flat_ip_topk(
        jnp.asarray(q), jnp.asarray(p), k,
        group=32, tile_rows=64, query_tile=2, interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_streaming_topk_equals_flat_ip_topk(rng):
    q, p = problem(rng, q=5, n=3000, d=24)
    p[[7, 900, 2999]] = p[100]  # exact ties across groups
    for group in (8, 32, 128):
        s, i = tss.streaming_flat_ip_topk(t(q), t(p), 50, group=group)
        fs, fi = tes.flat_ip_topk(t(q), t(p), 50)
        assert torch.equal(i, fi)
        np.testing.assert_allclose(s.numpy(), fs.numpy(), atol=1e-5, rtol=0)


def test_streaming_topk_int8_equals_int_oracle(rng):
    queries, passages = problem(rng, q=9, n=700, d=48)
    quant = Int8Quantizer.fit(passages)
    p_i8 = quant.quantize_passages(passages)
    q_int, _tq = quant.quantize_queries(queries)
    os_, oi = int8_topk_oracle(q_int, p_i8, 25)
    for group in (32, 128):
        s, i = tss.streaming_flat_ip_topk(t(q_int), t(p_i8), 25, group=group)
        np.testing.assert_array_equal(i.numpy(), oi)
        np.testing.assert_array_equal(s.numpy(), os_)  # integer-exact


def test_streaming_rejects_bad_group(rng):
    q, p = problem(rng)
    with pytest.raises(ValueError, match="group"):
        tss.streaming_flat_ip_topk(t(q), t(p), 5, group=24)


# ---------------------------------------------------------------------------
# the group gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_dma_gather_matches_pallas_interpret(rng, idx_dtype):
    qn, b, g, k = 16, 1024, 32, 5
    scores = rng.randn(qn, b).astype(np.float32)
    gsel = rng.randint(0, b // g, size=(qn, k)).astype(idx_dtype)
    got = tgg.dma_gather_groups(t(scores), t(gsel), group=g)
    want = jps.dma_gather_groups(
        jnp.asarray(scores), jnp.asarray(gsel.astype(np.int32)), group=g, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgg.dma_gather_groups.launches == 0


def test_dma_gather_takes_shapes_the_tpu_kernel_did_not(rng):
    # Q % 8 != 0 and B % 128 != 0: Mosaic tiling limits, not the contract
    qn, b, g, k = 15, 1000, 8, 7
    scores = rng.randn(qn, b).astype(np.float32)
    gsel = rng.randint(0, b // g, size=(qn, k))
    got = tgg.dma_gather_groups(t(scores), t(gsel), group=g).numpy()
    for r in range(qn):
        for j, grp in enumerate(gsel[r]):
            np.testing.assert_array_equal(got[r, j], scores[r, grp * g:(grp + 1) * g])


def test_dma_gather_rejects_what_it_does_not_take():
    gsel = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="f32"):
        tgg.dma_gather_groups(torch.zeros((16, 1024), dtype=torch.bfloat16), gsel)
    with pytest.raises(ValueError, match="multiple of group"):
        tgg.dma_gather_groups(torch.zeros((16, 1000)), gsel, group=48)
    with pytest.raises(ValueError, match="int32 or int64"):
        tgg.dma_gather_groups(torch.zeros((16, 1024)), gsel.float())


@pytest.mark.parametrize("gather", ["auto", "onehot", "dma"])
def test_flat_ip_topk_gather_options_match_jax(rng, gather):
    q, p = problem(rng, q=5, n=3000, d=16)
    s, i = tes.flat_ip_topk(t(q), t(p), 40, block_rows=1024, gather=gather)
    js, ji = jes.flat_ip_topk(jnp.asarray(q), jnp.asarray(p), 40, block_rows=1024)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)


def test_flat_ip_topk_unknown_gather_raises(rng):
    q, p = problem(rng)
    with pytest.raises(ValueError, match="unknown gather"):
        tes.flat_ip_topk(t(q), t(p), 5, gather="scatter")
