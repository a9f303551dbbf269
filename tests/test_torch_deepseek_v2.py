"""DeepSeek-V2 as a RepLLaMA-style encoder (``rep_deepseek_v2``) on the CPU
at a tiny size (hidden 64, one dense and three expert layers of 8 experts,
top-2, one shared expert) with seeded f32 weights, against the plain
reference (``h100_bench/reference/deepseek_v2.py``); its YaRN, causality,
pad invariance, the grouped expert product, checkpoint loading by the
Hugging Face leaf names and ``generate_embeddings`` end to end. The card's
kernels (kernel 1's causal (192, 128) variant and the grouped Triton
product) against their plain twins are marked ``cuda``:

    python -m pytest --noconftest -m cuda tests/test_torch_deepseek_v2.py
"""

import json
import math
import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convdr_torch.core.config import DecoderArchConfig
from convdr_torch.core.loading import load_decoder, load_model_and_params, make_apply_fn
from convdr_torch.core.registry import get_model_config
from convdr_torch.data.token_cache import TokenCache, TokenCacheWriter
from convdr_torch.models import deepseek_v2 as ds
from convdr_torch.models.attention import (
    causal_attention,
    causal_attention_plain,
)
from convdr_torch.models.encoders import build_model
from convdr_torch.ops import moe
from convdr_torch.retrieval.embed_corpus import generate_embeddings
from h100_bench import weights_llm
from h100_bench.drivers import embed_llm
from h100_bench.reference import deepseek_v2 as reference

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "h100_bench", "tests", "tiny", "dsv2lite-cast.json")


def tiny_cfg(dtype="float32") -> dict:
    with open(TINY) as f:
        return dict(json.load(f), compute_dtype=dtype)


def tiny_model(seed=3, dtype="float32"):
    return embed_llm.build(tiny_cfg(dtype), seed, torch.device("cpu"))


def sequences(seed, lengths, vocab=298):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(0, vocab, n)) for n in lengths]


def padded(seqs, width):
    ids = torch.zeros((len(seqs), width), dtype=torch.int64)
    mask = torch.zeros_like(ids)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return ids, mask


def test_tiny_arch_has_the_test_widths():
    a = DecoderArchConfig.tiny()
    assert (a.hidden_size, a.num_layers, a.first_k_dense_replace) == (64, 4, 1)
    assert (a.n_routed_experts, a.num_experts_per_tok, a.n_shared_experts) == (8, 2, 1)
    cfg = tiny_cfg()
    assert embed_llm.arch(cfg) == DecoderArchConfig.tiny(vocab_size=300)


@pytest.mark.parametrize("lengths", [(5, 17, 33, 60), (1, 2, 64), (40,)])
def test_port_matches_the_plain_reference(lengths):
    """f32 both ways, the same seeded weights: embeddings within 2e-6 (the
    order of the f32 sums differs: packed rows, batched einsums) and every
    expert layer's top-2 choices the same."""
    cfg = tiny_cfg()
    model = tiny_model()
    seqs = sequences(len(lengths), lengths)
    ids, mask = padded(seqs, 64)
    prog_choices = [layer["experts"][0][0]
                    for layer in embed_llm.recorded_blocks(model, ids, mask)
                    if layer["experts"] is not None]
    with torch.no_grad():
        emb = model.body_emb(ids, mask)
    ref, ref_choices = reference.embed_sequences(
        cfg, weights_llm.LeafMaker(cfg, 3, torch.device("cpu")), seqs)
    assert emb.dtype == torch.float32 and emb.shape == (len(lengths), 64)
    assert torch.allclose(emb, ref, atol=2e-6, rtol=0)
    assert len(prog_choices) == len(ref_choices) == 3
    for p, r in zip(prog_choices, ref_choices):
        assert torch.equal(torch.sort(p, 1)[0], torch.sort(r, 1)[0])


def test_query_and_body_embeddings_are_one_tower():
    model = tiny_model()
    ids, mask = padded(sequences(0, (9, 30)), 32)
    with torch.no_grad():
        a, b, c = model.query_emb(ids, mask), model.body_emb(ids, mask), model(ids, mask)
    assert torch.equal(a, b) and torch.equal(b, c)
    assert torch.allclose(a.norm(dim=1), torch.ones(2), atol=1e-6)


def test_yarn_inv_freq_and_softmax_scale_follow_the_formulas():
    a = DecoderArchConfig()  # DeepSeek-V2-Lite's published rope_scaling
    dim, base = 64, 10000.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    freq = np.array([base ** (-2 * i / dim) for i in range(dim // 2)])
    ramp = np.clip((np.arange(dim // 2) - low) / (high - low), 0, 1)
    want = freq * (1 - ramp) + freq / 40 * ramp
    got = ds.yarn_inv_freq(a).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.allclose(got[:low], freq[:low], rtol=1e-6)  # high frequencies kept
    assert np.allclose(got[high:], freq[high:] / 40, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ds.softmax_scale(a) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    cos, sin = ds.rope_cos_sin(a, torch.arange(5))
    assert torch.allclose(cos[:, :32], cos[:, 32:]) and torch.equal(cos[0], torch.ones(64))
    cfg = json.load(open(TINY.replace("tests/tiny", "configs")))
    assert torch.allclose(reference.yarn_inv_freq(cfg), ds.yarn_inv_freq(a))
    assert reference.softmax_scale(cfg) == pytest.approx(ds.softmax_scale(a), rel=1e-12)


def test_rope_deinterleaves_before_rotate_half():
    x = torch.arange(8, dtype=torch.float32).view(1, 1, 8)
    cos = torch.zeros(1, 8)
    sin = torch.ones(1, 8)
    # de-interleaved: [0, 2, 4, 6, 1, 3, 5, 7]; rotate_half: [-1, -3, -5, -7, 0, 2, 4, 6]
    assert ds.apply_rope(x, cos, sin).flatten().tolist() == [-1, -3, -5, -7, 0, 2, 4, 6]


def _hidden_states(model, ids, mask):
    """The last decoder layer's output rows [N, H] of the valid tokens."""
    got = []
    handle = model.model.layers[-1].register_forward_hook(lambda m, a, out: got.append(out))
    with torch.no_grad():
        model.body_emb(ids, mask)
    handle.remove()
    return got[0]


@pytest.mark.parametrize("changed", [5, 11, 19])
def test_a_later_token_leaves_earlier_positions(changed):
    model = tiny_model()
    (seq,) = sequences(1, (20,))
    other = seq.clone()
    other[changed] = (other[changed] + 1) % 298
    ids, mask = padded([seq, other], 20)
    h = _hidden_states(model, ids, mask)
    a, b = h[:20], h[20:]
    assert torch.equal(a[:changed], b[:changed])
    assert not torch.equal(a[changed:], b[changed:])


@pytest.mark.parametrize("width", [24, 40, 64])
def test_pads_change_nothing(width):
    model = tiny_model()
    seqs = sequences(2, (3, 24, 11))
    ids, mask = padded(seqs, 24)
    wide, wide_mask = padded(seqs, width)
    wide[wide_mask == 0] = 297  # other pad ids
    with torch.no_grad():
        a = model.body_emb(ids, mask)
        b = model.body_emb(wide, wide_mask)
        alone = torch.cat([model.body_emb(*padded([s], len(s))) for s in seqs])
    assert torch.allclose(a, b, atol=1e-6, rtol=0)
    assert torch.allclose(a, alone, atol=1e-6, rtol=0)


def _per_token_loop(x, experts, w_gate, w_up, w_down):
    """Each token's k routed rows, one at a time, in f64 -> [N, k, H]."""
    n, k = experts.shape
    out = torch.zeros((n, k, w_down.shape[1]), dtype=torch.float64)
    for t in range(n):
        for j in range(k):
            e = int(experts[t, j])
            xe = x[t].double()
            act = F.silu(w_gate[e].double() @ xe) * (w_up[e].double() @ xe)
            out[t, j] = w_down[e].double() @ act
    return out


@pytest.mark.parametrize("n,e,k", [(37, 8, 2), (5, 8, 2), (64, 4, 3), (1, 8, 2)])
def test_grouped_product_plain_path_against_a_per_token_loop(n, e, k):
    g = torch.Generator().manual_seed(n * 10 + e)
    h, inter = 16, 24
    x = torch.randn((n, h), generator=g, dtype=torch.float64)
    w_gate = torch.randn((e, inter, h), generator=g, dtype=torch.float64) / 4
    w_up = torch.randn((e, inter, h), generator=g, dtype=torch.float64) / 4
    w_down = torch.randn((e, h, inter), generator=g, dtype=torch.float64) / 5
    gate = torch.randn((e, h), generator=g)
    weights, experts = moe.route(x, gate, k)
    slots, counts, row_off, tile_off = moe.order_by_expert(experts, e, block_m=4)
    assert counts.sum() == n * k and row_off[-1] == n * k
    assert torch.equal(tile_off[1:] - tile_off[:-1], (counts + 3) // 4)
    # sorted by expert, a token's rows in order within one
    assert bool((experts.reshape(-1)[slots][1:] >= experts.reshape(-1)[slots][:-1]).all())
    y = moe.grouped_swiglu(x, slots, row_off, tile_off, weights.double(), w_gate, w_up, w_down)
    want = _per_token_loop(x, experts, w_gate, w_up, w_down) * weights.double()[..., None]
    assert torch.allclose(y.view(n, k, h), want, atol=1e-12, rtol=1e-10)
    assert torch.allclose(moe.combine(y, k), want.sum(1), atol=1e-12)


def test_router_takes_its_logits_in_f32_and_does_not_renormalise():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 16), generator=g).to(torch.bfloat16)
    gate = torch.randn((8, 16), generator=g)
    w, e = moe.route(x, gate, 3, scaling=1.0)
    probs = torch.softmax(x.float() @ gate.T, dim=-1)
    assert w.dtype == torch.float32
    assert torch.allclose(w, torch.gather(probs, 1, e))
    assert bool((w.sum(1) < 1).all())


def _recorded(model, seqs):
    ids, mask = padded(seqs, max(len(s) for s in seqs))
    layers = embed_llm.recorded_blocks(model, ids, mask)
    return embed_llm.program_records(tiny_cfg(), layers, sum(len(s) for s in seqs))


ROUTE_SEQS = (40, 63, 17, 64, 29, 50, 8, 61)


def test_routing_is_recorded_as_routed_and_held_to_the_exact_router(monkeypatch):
    """Inside ``recording_blocks`` each layer keeps one call's blocks and
    each expert layer its chosen experts; the f32 router reads no set off
    the f64 router's, and a router with bf16 logits planted in the program
    reads some, as the fault read from the same rows does."""
    cfg = tiny_cfg()
    model = tiny_model()
    seqs = sequences(12, ROUTE_SEQS)
    n = sum(len(s) for s in seqs)
    records = _recorded(model, seqs)
    assert all(m.blocks is None for m in model.modules() if isinstance(m, ds.DecoderLayer))
    assert all(m.routing is None for m in model.modules() if isinstance(m, ds.ExpertLayer))
    assert [(r[0], r[1]) for r in records] == [(0, "attn"), (0, "mlp")] + [
        (i, k) for i in range(1, 4) for k in ("attn", "mlp", "routed")]
    assert all(r[2].shape == r[3].shape == (n, 64) for r in records)
    assert [r[4] is None for r in records] == [True, True] + [True, False, False] * 3
    assert all(r[4].shape == (n, 2) for r in records if r[4] is not None)
    assert all(r[2] is s[2] for r, s in zip(records[3::3], records[4::3]))  # the MLP's input
    leaf = weights_llm.LeafMaker(cfg, 3, torch.device("cpu"))
    assert embed_llm.route_differs(cfg, leaf, records) == 0.0
    assert embed_llm.route_differs(cfg, leaf, records, embed_llm.ROUTER_FAULTS["bf16"]) > 0
    assert math.isnan(embed_llm.route_differs(cfg, leaf, None))
    ids, mask = padded(seqs, 64)
    layers = embed_llm.recorded_blocks(model, ids, mask)
    assert embed_llm.program_records(cfg, layers, n + 1) is None
    assert embed_llm.program_records(cfg, layers[1:], n) is None
    real = moe.route

    def bf16_route(x, gate_weight, top_k, scaling=1.0):
        logits = F.linear(x.bfloat16(), gate_weight.bfloat16()).float()
        w, e = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
        return w * scaling, e

    monkeypatch.setattr(moe, "route", bf16_route)
    assert embed_llm.route_differs(cfg, leaf, _recorded(model, seqs)) > 0
    monkeypatch.setattr(moe, "route", real)


def test_each_block_is_held_to_the_reference_on_its_own_input(monkeypatch):
    """The f32 program's attention and MLP blocks lie within f32 rounding
    of the plain reference's blocks on the same input rows; routed experts
    whose products take fp8 operands (one precision below bf16) read far
    off, as the fault does on the reference's own inputs."""
    cfg = tiny_cfg()
    model = tiny_model()
    seqs = sequences(13, ROUTE_SEQS)
    lengths = [len(s) for s in seqs]
    leaf = weights_llm.LeafMaker(cfg, 3, torch.device("cpu"))
    gaps = embed_llm.block_gaps(cfg, leaf, _recorded(model, seqs), lengths)
    assert set(gaps) == {"attn", "mlp", "routed"} and max(gaps.values()) < 1e-5, gaps
    real = moe.grouped_swiglu

    def fp8_experts(x, slots, row_off, tile_off, weights, w_gate, w_up, w_down):
        r = embed_llm.fp8
        return moe.grouped_swiglu_plain(r(x), slots, row_off, weights, r(w_gate), r(w_up),
                                        r(w_down))

    monkeypatch.setattr(moe, "grouped_swiglu", fp8_experts)
    faulty = embed_llm.block_gaps(cfg, leaf, _recorded(model, seqs), lengths)
    monkeypatch.setattr(moe, "grouped_swiglu", real)
    assert faulty["attn"] < 1e-5 and faulty["mlp"] > 1e-2 and faulty["routed"] > 1e-2, faulty
    record = []
    reference.embed_sequences(cfg, leaf, seqs, record=record)
    routed = [(i, "routed", h, None, e) for i, k, h, e in record if e is not None]
    stand_in = embed_llm.block_gaps(
        cfg, leaf, [(i, k, h, None, e) for i, k, h, e in record] + routed, lengths,
        {"experts_fp8": lambda kind: {"rnd_experts": embed_llm.fp8} if kind == "routed" else {}})
    assert stand_in["experts_fp8"] > 1e-2


def test_moe_stats_count_the_routed_rows():
    model = tiny_model()
    ids, mask = padded(sequences(4, (7, 13)), 16)
    ds.reset_moe_stats(model)
    assert ds.moe_stats(model)["load_max_mean"] is None
    with torch.inference_mode():
        model.body_emb(ids, mask)
    with torch.no_grad():
        model.body_emb(ids, mask)  # counters made under inference mode stay usable
    stats = ds.moe_stats(model)
    assert stats["calls"] == 6 and len(stats["routed_rows"]) == 3
    assert all(sum(r) == 2 * 20 * 2 for r in stats["routed_rows"])  # 2 calls, 20 tokens, top-2
    assert stats["load_max_mean"] >= 1.0


def _hf_state(seed=5):
    cfg = tiny_cfg()
    state = dict(weights_llm.leaves(cfg, seed, torch.device("cpu")))
    state["lm_head.weight"] = torch.zeros(cfg["vocab_size"], cfg["hidden_size"])
    return state


def test_deepseek_leaf_names_load_through_core_loading(tmp_path):
    state = _hf_state()
    assert set(state) - {"lm_head.weight"} == ds.hf_leaf_names(DecoderArchConfig.tiny(300))
    assert "model.layers.2.mlp.experts.7.down_proj.weight" in state
    assert "model.layers.0.self_attn.kv_a_proj_with_mqa.weight" in state
    torch.save(state, tmp_path / "pytorch_model.bin")
    config, tokenizer, model = load_model_and_params(
        "rep_deepseek_v2", str(tmp_path), device=torch.device("cpu"), arch_preset="tiny",
        arch_overrides={"vocab_size": 300})
    assert tokenizer is None and isinstance(config.arch, DecoderArchConfig)
    direct = tiny_model(seed=5)
    ids, mask = padded(sequences(6, (12, 30)), 32)
    with torch.no_grad():
        assert torch.equal(model.body_emb(ids, mask), direct.body_emb(ids, mask))
    assert torch.equal(model.model.layers[1].mlp.experts.up_proj[3],
                       state["model.layers.1.mlp.experts.3.up_proj.weight"])


def test_sharded_safetensors_checkpoint_loads_by_its_index(tmp_path):
    """The real checkpoint's layout: shards listed by
    ``model.safetensors.index.json``."""
    safetensors = pytest.importorskip("safetensors.torch")
    state = _hf_state()
    names = sorted(state)
    halves = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for shard, keys in halves.items():
        safetensors.save_file({k: state[k].contiguous() for k in keys}, str(tmp_path / shard))
    index = {"weight_map": {k: shard for shard, keys in halves.items() for k in keys}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
    _cfg, _tok, model = load_model_and_params(
        "rep_deepseek_v2", str(tmp_path), device=torch.device("cpu"), arch_preset="tiny",
        arch_overrides={"vocab_size": 300})
    ids, mask = padded(sequences(8, (5, 19)), 19)
    with torch.no_grad():
        assert torch.equal(model.body_emb(ids, mask), tiny_model(seed=5).body_emb(ids, mask))


def test_a_single_safetensors_file_streams_its_leaves(tmp_path):
    """``model.safetensors`` alone is read leaf by leaf; a
    ``pytorch_model.bin`` beside it is the one read (the encoders' order)."""
    from convdr_torch.core.loading import hf_checkpoint_leaves

    safetensors = pytest.importorskip("safetensors.torch")
    state = _hf_state()
    safetensors.save_file({k: v.contiguous() for k, v in state.items()},
                          str(tmp_path / "model.safetensors"))
    leaves = hf_checkpoint_leaves(str(tmp_path))
    name, first = next(leaves)
    assert torch.equal(first, state[name])
    assert {name} | {n for n, _ in leaves} == set(state)
    _cfg, _tok, model = load_model_and_params(
        "rep_deepseek_v2", str(tmp_path), device=torch.device("cpu"), arch_preset="tiny",
        arch_overrides={"vocab_size": 300})
    ids, mask = padded(sequences(8, (5, 19)), 19)
    with torch.no_grad():
        assert torch.equal(model.body_emb(ids, mask), tiny_model(seed=5).body_emb(ids, mask))
    other = _hf_state(seed=6)
    torch.save(other, tmp_path / "pytorch_model.bin")
    got = dict(hf_checkpoint_leaves(str(tmp_path)))
    assert torch.equal(got["model.norm.weight"], other["model.norm.weight"])


def test_fresh_weights_without_a_checkpoint():
    """No checkpoint: the weights come from a leaf source, streamed one leaf
    at a time into parameters built empty in the compute dtype; with
    neither a checkpoint nor leaves the decoder is refused (no seeded init
    of its own)."""
    cfg = tiny_cfg("bfloat16")
    mc = get_model_config("rep_deepseek_v2", arch=embed_llm.arch(cfg), embedding_dim=64)
    taken = []

    def source():
        for name, t in weights_llm.leaves(cfg, 3, torch.device("cpu")):
            taken.append(name)
            yield name, t

    _cfg, tokenizer, model = load_decoder(mc, None, device=torch.device("cpu"),
                                          dtype=torch.bfloat16, leaves=source())
    assert tokenizer is None and taken == [e[0] for e in weights_llm.param_spec(cfg)]
    assert not any(p.is_meta for p in model.parameters())
    layer = model.model.layers[2]
    assert layer.mlp.experts.down_proj.dtype == torch.bfloat16
    assert layer.input_layernorm.weight.dtype == layer.mlp.gate.weight.dtype == torch.float32
    direct = dict(weights_llm.leaves(cfg, 3, torch.device("cpu")))
    assert torch.equal(layer.mlp.experts.down_proj[5],
                       direct["model.layers.2.mlp.experts.5.down_proj.weight"])
    assert torch.equal(layer.mlp.gate.weight, direct["model.layers.2.mlp.gate.weight"].float())
    ids, mask = padded(sequences(9, (6, 12), vocab=250), 12)
    with torch.no_grad():
        emb = model.body_emb(ids, mask)
    assert torch.allclose(emb.norm(dim=1), torch.ones(2), atol=1e-6)
    with pytest.raises(ValueError, match="no seeded init"):
        load_model_and_params("rep_deepseek_v2", None, device=torch.device("cpu"),
                              arch_preset="tiny")


@pytest.mark.parametrize("fault", ["repeated", "unexpected"])
def test_a_leaf_source_with_a_stray_leaf_is_refused(fault):
    cfg = tiny_cfg()
    mc = get_model_config("rep_deepseek_v2", arch=embed_llm.arch(cfg), embedding_dim=64)
    leaves = list(weights_llm.leaves(cfg, 3, torch.device("cpu")))
    if fault == "repeated":
        leaves.insert(3, leaves[1])
    else:
        leaves.append(("model.layers.9.mlp.gate.weight", leaves[1][1]))
    with pytest.raises(KeyError, match=fault):
        load_decoder(mc, None, device=torch.device("cpu"), leaves=iter(leaves))


def test_a_checkpoint_missing_a_leaf_is_refused(tmp_path):
    state = _hf_state()
    del state["model.layers.3.mlp.experts.2.gate_proj.weight"]
    torch.save(state, tmp_path / "pytorch_model.bin")
    with pytest.raises(KeyError, match="missing"):
        load_model_and_params("rep_deepseek_v2", str(tmp_path), device=torch.device("cpu"),
                              arch_preset="tiny", arch_overrides={"vocab_size": 300})


def test_registry_entry_builds_the_decoder():
    mc = get_model_config("rep_deepseek_v2")
    assert mc.embedding_dim == 2048 and not mc.two_tower and not mc.projection_head
    assert isinstance(mc.arch, DecoderArchConfig) and mc.arch.num_layers == 27
    with torch.device("meta"):
        model = build_model(mc)
    assert isinstance(model, ds.DeepseekV2Encoder)
    held = sum(p.numel() for p in model.parameters())
    assert held == weights_llm.total_params(
        json.load(open(TINY.replace("tests/tiny", "configs"))))


@pytest.mark.parametrize("buckets", [None, (16, 32, 48)])
def test_generate_embeddings_end_to_end_on_a_tiny_token_cache(tmp_path, buckets):
    model = tiny_model()
    seqs = sequences(7, (4, 20, 47, 9, 33, 12, 48, 16, 25))
    with TokenCacheWriter(str(tmp_path / "cache"), 48) as w:
        for s in seqs:
            w.write(s.tolist())
    rows = generate_embeddings(make_apply_fn(model), TokenCache(str(tmp_path / "cache")),
                               str(tmp_path / "out"), device=torch.device("cpu"),
                               batch_size=4, length_buckets=buckets)
    assert rows == len(seqs)
    with open(tmp_path / "out" / "passage__emb_p__data_obj_0.pb", "rb") as f:
        emb = np.asarray(pickle.load(f))
    with open(tmp_path / "out" / "passage__embid_p__data_obj_0.pb", "rb") as f:
        offsets = np.asarray(pickle.load(f))
    assert sorted(offsets.tolist()) == list(range(len(seqs)))
    with torch.no_grad():
        alone = torch.cat([model.body_emb(*padded([s], len(s))) for s in seqs]).numpy()
    np.testing.assert_allclose(emb, alone[offsets], atol=1e-6)


def test_causal_attention_plain_sees_earlier_keys_of_its_segment():
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 6, 2, 8), generator=g, dtype=torch.float64)
    k = torch.randn((2, 6, 2, 8), generator=g, dtype=torch.float64)
    v = torch.randn((2, 6, 2, 4), generator=g, dtype=torch.float64)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    out = causal_attention(q, k, v, mask, 0.3)
    for b in range(2):
        for t in range(6):
            keys = [s for s in range(t + 1) if mask[b, s] == mask[b, t]]
            s = torch.einsum("hd,shd->hs", q[b, t], k[b, keys]) * 0.3
            want = torch.einsum("hs,shd->hd", torch.softmax(s, -1), v[b, keys])
            assert torch.allclose(out[b, t], want, atol=1e-12)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, T, H): T that cut the 64-row blocks and the diagonal tile, the corpus
# rungs at the cell's batch, and rows past 512 (the accumulators' flush)
CAUSAL_CASES = [(2, 1, 16), (3, 63, 16), (2, 65, 2), (4, 100, 16), (2, 129, 3),
                (1024, 128, 16), (256, 512, 16), (2, 513, 2), (1, 2048, 2), (4, 777, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", CAUSAL_CASES)
def test_causal_kernel_matches_plain(cuda, b, t, h):
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + t)
    q, k = (torch.randn((b, t, h, 192), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((b, t, h, 128), generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).int()
    before = causal_attention.launches
    out = causal_attention(q, k, v, mask, 0.1)
    torch.cuda.synchronize()
    assert causal_attention.launches == before + 1
    ref = causal_attention_plain(q, k, v, mask, 0.1)
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= 1e-6 + 2.0 ** -7 * ref.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,k,h,inter", [(3000, 64, 6, 2048, 1408), (200, 64, 6, 2048, 1408),
                                           (37, 8, 2, 64, 32), (5000, 16, 4, 256, 192)])
def test_grouped_kernel_matches_plain(cuda, n, e, k, h, inter):
    gen = torch.Generator(device="cuda").manual_seed(n + e)
    x = torch.randn((n, h), generator=gen, device="cuda").to(torch.bfloat16)
    w_gate, w_up = (torch.randn((e, inter, h), generator=gen, device="cuda").mul(h ** -0.5)
                    .to(torch.bfloat16) for _ in range(2))
    w_down = torch.randn((e, h, inter), generator=gen, device="cuda").mul(inter ** -0.5) \
        .to(torch.bfloat16)
    gate = torch.randn((e, h), generator=gen, device="cuda").mul(h ** -0.5)  # as the router's
    weights, experts = moe.route(x, gate, k)
    slots, _counts, row_off, tile_off = moe.order_by_expert(experts, e)
    before = moe.grouped_swiglu.launches
    y = moe.grouped_swiglu(x, slots, row_off, tile_off, weights, w_gate, w_up, w_down)
    torch.cuda.synchronize()
    assert moe.grouped_swiglu.launches == before + 2
    plain = moe.grouped_swiglu_plain(x, slots, row_off, weights, w_gate, w_up, w_down).double()
    # the exact products of the bf16 operands, nothing rounded
    truth = moe.grouped_swiglu_plain(x.double(), slots, row_off, weights.double(),
                                     w_gate.double(), w_up.double(), w_down.double())
    scale = truth.pow(2).mean(1, keepdim=True).sqrt()
    err = ((y.double() - truth).abs() / scale).max().item()
    err_plain = ((plain - truth).abs() / scale).max().item()
    # both round the activation and the weighted output to bf16 from f32 sums
    # taken in other orders, so an element may round to the neighbouring bf16
    # value, and an activation that did moves a small output by more than one
    # of its own bf16 steps: the kernel is as far from the exact products as
    # the plain version, and 99% of the elements lie within one bf16 step of
    # it (99.45% on the card at the cell's widths)
    within = ((y.double() - plain).abs() <= 2.0 ** -7 * plain.abs()).double().mean().item()
    assert err <= err_plain + 2.0 ** -8, (err, err_plain, within)
    assert within >= 0.99, (err, err_plain, within)
    assert bool(torch.isfinite(y).all())
