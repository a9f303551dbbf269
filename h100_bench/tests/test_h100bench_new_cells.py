"""The decoder embed cell and the four-rank sharded search cell on the CPU at
the tiny size: whole runs, the sharded driver's answers against one
process's merge of every shard, and planted faults that each check
catches."""

import numpy as np
import pytest
import torch

from h100_bench import harness, sharded
from h100_bench.tests.tinybench import run_tiny, tiny_config, tiny_mix
from convdr_torch.models.deepseek_v2 import DeepseekV2Encoder

NEW = ["dsv2lite-cast.embed-llm", "ance-cast.batch-sharded4"]


def failed(res):
    res.pop("_forbidden")
    return not res["correct"] and any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", NEW)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_a_new_cell_is_correct(tmp_path, cell, trace):
    res = run_tiny(tmp_path, cell, trace=trace)
    assert res.pop("_forbidden") == []
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(harness.load_manifest(), cell, trace)}
    if trace:
        assert set(res["metrics"]) <= want and res["metrics"]
    else:
        assert set(res["metrics"]) == want


def test_the_sharded_driver_gives_the_one_process_merge(tmp_path):
    """Four gloo ranks, each searching its own shard, against one process
    that makes every shard and merges the local searches with no
    collective."""
    from convdr_torch.models.encoders import build_model  # noqa: F401
    from convdr_torch.parallel.sharded_search import local_flat_ip_topk, merge_shard_topk
    from h100_bench import program, weights

    cfg, mix = tiny_config("ance-cast"), tiny_mix("batch-sharded4")
    ctx = harness.Ctx(cfg, mix, 2 ** 33 + 5, 0.1, torch.device("cpu"))
    driver = harness.load_driver("search_sharded")
    st = driver.setup(ctx)
    try:
        got = [driver.call(st) for _ in range(2)]
    finally:
        driver.stop(st)
    model = program.build_model(cfg, weights.make_weights(cfg, ctx.seed, ctx.device), ctx.device)
    _rows, n, _per = sharded.shape(cfg, 4)
    shards = [sharded.make_shard(cfg, ctx.seed, s, ctx.device, 4) for s in range(4)]
    for i, s, r in got:
        ids, mask = st.rank.queries.call(i, mix["queries_per_call"])
        with torch.inference_mode():
            q = model.query_emb(torch.from_numpy(ids), torch.from_numpy(mask))
        parts = [local_flat_ip_topk(q, shards[k], cfg["top_k"], k, 4, valid_rows=n,
                                    block_rows=cfg["block_rows"]) for k in range(4)]
        want_s, want_r = merge_shard_topk(torch.stack([p[0] for p in parts]),
                                          torch.stack([p[1] for p in parts]), cfg["top_k"])
        assert np.array_equal(r, want_r.numpy())
        assert np.allclose(s, want_s.numpy(), atol=1e-6)
        assert r.max() < n and r.max() >= cfg["corpus_rows"]  # rows from the last shards


def test_shard_zero_is_the_one_card_corpus():
    from h100_bench import weights

    cfg = tiny_config("ance-cast")
    one = weights.make_corpus(cfg, 11, torch.device("cpu"), 1)
    assert torch.equal(sharded.make_shard(cfg, 11, 0, torch.device("cpu"), 4), one)
    assert not torch.equal(sharded.make_shard(cfg, 11, 1, torch.device("cpu"), 4), one)


@pytest.mark.parametrize("fault", ["score", "row", "repeat"])
def test_a_planted_altered_answer_fails_the_sharded_check(tmp_path, monkeypatch, fault):
    real = sharded.Rank.call

    def altered(self):
        i, s, r = real(self)
        if self.shard_id == 0:
            s, r = s.clone(), r.clone()
            if fault == "score":
                s[:, 0] += 1e-3 * s[:, 0].abs()
            elif fault == "row":
                r[:, 0] = (r[:, 0] + 1) % 20000
            else:
                r[:, 1] = r[:, 0]
        return i, s, r

    monkeypatch.setattr(sharded.Rank, "call", altered)
    res = run_tiny(tmp_path, "ance-cast.batch-sharded4")
    name = {"score": "score_gap", "row": "score_gap", "repeat": "bad_rows"}[fault]
    assert res["checks"][name]["value"] > res["checks"][name]["limit"]
    assert failed(res)


@pytest.mark.parametrize("fault", ["row", "drop"])
def test_a_planted_altered_row_fails_the_embed_check(tmp_path, monkeypatch, fault):
    real = DeepseekV2Encoder.body_emb

    def altered(self, ids, mask):
        out = real(self, ids, mask)
        if fault == "row":
            out = out.clone()
            out[:, :4] = out[:, 4:8]  # every row's first dims are others
        else:
            out = out.clone()
            out[1:] = out[:1]  # passages embedded as the batch's first
        return out

    monkeypatch.setattr(DeepseekV2Encoder, "body_emb", altered)
    res = run_tiny(tmp_path, "dsv2lite-cast.embed-llm")
    assert res["checks"]["emb_gap"]["value"] > res["checks"]["emb_gap"]["limit"]
    assert failed(res)


def test_a_planted_router_in_bf16_fails_the_embed_check(tmp_path, monkeypatch):
    """A router whose logits are a bf16 product (one precision below the
    configuration's f32) sends some token-layers to another top-k set than
    the exact router on the same rows: ``route_differs`` fails while
    ``emb_gap`` need not."""
    from convdr_torch.ops import moe

    def bf16_route(x, gate_weight, top_k, scaling=1.0):
        logits = torch.nn.functional.linear(x.bfloat16(), gate_weight.bfloat16()).float()
        w, e = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
        return w * scaling, e

    monkeypatch.setattr(moe, "route", bf16_route)
    res = run_tiny(tmp_path, "dsv2lite-cast.embed-llm")
    assert res["checks"]["route_differs"]["value"] > res["checks"]["route_differs"]["limit"]
    assert failed(res)


def test_planted_fp8_experts_fail_the_embed_check(tmp_path, monkeypatch):
    """Routed experts whose products take fp8 operands (one precision below
    the configuration's bf16) leave their blocks far from the reference's
    block on the same input rows: ``block_gap`` fails."""
    from convdr_torch.ops import moe
    from h100_bench.reference.encoder import fp8

    def fp8_experts(x, slots, row_off, tile_off, weights, w_gate, w_up, w_down):
        return moe.grouped_swiglu_plain(fp8(x), slots, row_off, weights, fp8(w_gate),
                                        fp8(w_up), fp8(w_down))

    monkeypatch.setattr(moe, "grouped_swiglu", fp8_experts)
    res = run_tiny(tmp_path, "dsv2lite-cast.embed-llm")
    assert res["checks"]["block_gap"]["value"] > res["checks"]["block_gap"]["limit"]
    assert failed(res)
