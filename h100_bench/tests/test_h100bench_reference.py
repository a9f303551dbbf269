"""The plain reference at the tiny size against naive loop versions, and
the program against the plain reference on the CPU."""

import math

import numpy as np
import pytest
import torch

from h100_bench import checks, weights
from h100_bench.reference.encoder import embed
from h100_bench.reference.search import exact_topk_and_scores
from h100_bench.reference.train import B1, B2, PlainTrainer
from h100_bench.tests.tinybench import tiny_config, tiny_mix

CPU = torch.device("cpu")


def naive_layer_norm(x, w, b, eps):
    rows = []
    for i in range(x.shape[0]):
        mean = sum(x[i]) / x.shape[1]
        var = sum((v - mean) ** 2 for v in x[i]) / x.shape[1]
        rows.append((x[i] - mean) / torch.sqrt(var + eps) * w + b)
    return torch.stack(rows)


def naive_embed(w, cfg, ids, mask, prefix):
    """One sequence at a time, one query token and one head at a time."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = h // heads
    eps = cfg["layer_norm_eps"]
    out = []
    for b in range(ids.shape[0]):
        valid = [t for t in range(ids.shape[1]) if mask[b, t]]
        n = len(valid)
        pos = ([cfg["pad_token_id"] + 1 + j for j in range(n)]
               if cfg["position_ids"] == "roberta" else valid)
        e = prefix + "embeddings."
        x = torch.stack([w[e + "word_embeddings.weight"][ids[b, t]]
                         + w[e + "position_embeddings.weight"][p]
                         + w[e + "token_type_embeddings.weight"][0]
                         for t, p in zip(valid, pos)])
        x = naive_layer_norm(x, w[e + "LayerNorm.weight"], w[e + "LayerNorm.bias"], eps)
        for layer in range(cfg["num_hidden_layers"]):
            p = f"{prefix}encoder.layer.{layer}."

            def lin(y, name):
                return y @ w[p + name + ".weight"].T + w[p + name + ".bias"]

            q, k, v = (lin(x, "attention.self." + s) for s in ("query", "key", "value"))
            rows = []
            for i in range(n):
                parts = []
                for hh in range(heads):
                    sl = slice(hh * dh, (hh + 1) * dh)
                    s = [(q[i, sl] @ k[j, sl]) / math.sqrt(dh) for j in range(n)]
                    m = max(float(a.detach()) for a in s)
                    e = [torch.exp(a - m) for a in s]
                    z = sum(e)
                    parts.append(sum(e[j] / z * v[j, sl] for j in range(n)))
                rows.append(torch.cat(parts))
            ctx = torch.stack(rows)
            x = naive_layer_norm(x + lin(ctx, "attention.output.dense"),
                                 w[p + "attention.output.LayerNorm.weight"],
                                 w[p + "attention.output.LayerNorm.bias"], eps)
            f = lin(x, "intermediate.dense")
            f = 0.5 * f * (1 + torch.erf(f / math.sqrt(2)))
            x = naive_layer_norm(x + lin(f, "output.dense"), w[p + "output.LayerNorm.weight"],
                                 w[p + "output.LayerNorm.bias"], eps)
        first = x[:1]
        if cfg["head"] == "linear_layernorm":
            first = naive_layer_norm(first @ w["embeddingHead.weight"].T + w["embeddingHead.bias"],
                                     w["norm.weight"], w["norm.bias"], cfg["head_layer_norm_eps"])
        out.append(first[0])
    return torch.stack(out)


def tiny_inputs(cfg, b=3, t=12, seed=0):
    g = np.random.default_rng(seed)
    lo, hi = cfg["layout"]["token_ids"]
    ids = torch.from_numpy(g.integers(lo, hi, size=(b, t))).int()
    lengths = [t, 7, 3][:b]
    mask = torch.tensor([[1] * n + [0] * (t - n) for n in lengths], dtype=torch.int32)
    return ids, mask


@pytest.mark.parametrize("name,side", [("ance-cast", "query"), ("dpr-orquac", "query"),
                                       ("dpr-orquac", "body")])
def test_plain_encoder_against_naive_loops(name, side):
    cfg = tiny_config(name)
    w = {k: v.double() for k, v in weights.make_weights(cfg, 3, CPU).items()}
    ids, mask = tiny_inputs(cfg)
    got = embed(w, cfg, ids, mask, side)
    prefix = {"query": "question_model.", "body": "ctx_model."}[side] if cfg["towers"] == 2 \
        else "roberta."
    want = naive_embed(w, cfg, ids, mask, prefix)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def test_plain_encoder_ignores_padding():
    cfg = tiny_config("ance-cast")
    w = weights.make_weights(cfg, 3, CPU)
    ids, mask = tiny_inputs(cfg)
    other = ids.clone()
    other[mask == 0] = 7
    torch.testing.assert_close(embed(w, cfg, ids, mask), embed(w, cfg, other, mask))


def test_exact_topk_against_a_full_sort():
    g = torch.Generator().manual_seed(0)
    corpus = torch.randn(1000, 16, generator=g, dtype=torch.float64)
    q = torch.randn(4, 16, generator=g, dtype=torch.float64)
    blocks = [lambda lo=lo: (lo, corpus[lo:lo + 300]) for lo in range(0, 1000, 300)]
    rows = torch.tensor([[5, 999, 1000, -1]] * 4)
    s, i, given = exact_topk_and_scores(q, blocks, 10, rows)
    full = q @ corpus.T
    order = torch.argsort(full, dim=1, descending=True)[:, :10]
    assert torch.equal(i, order)
    torch.testing.assert_close(s, torch.gather(full, 1, order))
    torch.testing.assert_close(given[:, :2], full[:, [5, 999]])
    assert torch.isnan(given[:, 2:]).all()


def test_search_numbers_see_wrong_repeated_and_missing_rows():
    g = torch.Generator().manual_seed(1)
    corpus = torch.randn(500, 8, generator=g)
    q = torch.randn(2, 8, generator=g)
    blocks = [lambda: (0, corpus)]
    s, i, given = exact_topk_and_scores(q, blocks, 5, torch.zeros(2, 5, dtype=torch.long))
    _s, _i, given = exact_topk_and_scores(q, blocks, 5, i)
    sound = checks.search_numbers(s, i, q, s, given, 500)
    assert sound["score_gap"] < 1e-6 and sound["rank_gap"] < 1e-6 and sound["bad_rows"] == 0
    wrong = i.clone()
    wrong[:, 0] = torch.argmin(q @ corpus.T, dim=1)
    _s, _i, given_w = exact_topk_and_scores(q, blocks, 5, wrong)
    bad = checks.search_numbers(s, wrong, q, s, given_w, 500)
    assert bad["rank_gap"] > 0.1 and bad["score_gap"] > 0.1
    repeated = i.clone()
    repeated[:, 4] = repeated[:, 3]
    assert checks.search_numbers(s, repeated, q, s, given, 500)["bad_rows"] == 2
    assert checks.search_numbers(s[:, :4], i[:, :4], q, s, given, 500)["bad_rows"] == 2


def test_plain_trainer_step_against_a_naive_adamw():
    cfg, mix = tiny_config("ance-cast"), tiny_mix("train-kd-rank")
    # small enough for the naive loops: 2 examples, 2 negatives, short rows
    mix = dict(mix, learning_rate=1e-3, max_grad_norm=0.5, total_steps=10, batch_size=2,
               num_negatives=2, max_concat_length=16, max_query_length=8, max_doc_length=12,
               turns_per_session=[2, 3], question_tokens=[2, 4], rewrite_tokens=[2, 4],
               doc_tokens={"law": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 10})
    w0 = {k: v.double() for k, v in weights.make_weights(cfg, 4, CPU).items()}
    from h100_bench import traffic
    from h100_bench.drivers.train import upload

    batches = [upload(b, CPU) for b in traffic.train_batches(mix, cfg["layout"], 4)[:2]]
    ref = PlainTrainer(cfg, mix, w0)
    ref.step(batches[0])
    ref.step(batches[1])
    # naive: the same loss through the naive encoder, the update element by
    # element in Python floats
    params = {n: v.clone().requires_grad_(True) for n, v in w0.items()}
    mu = {n: torch.zeros_like(v) for n, v in w0.items()}
    nu = {n: torch.zeros_like(v) for n, v in w0.items()}
    for step, b in enumerate(batches):
        q = naive_embed(params, cfg, b["concat_ids"], b["concat_mask"], "roberta.")
        with torch.no_grad():
            t = naive_embed(w0, cfg, b["target_ids"], b["target_mask"], "roberta.")
            d = naive_embed(w0, cfg, b["doc_ids"].reshape(-1, b["doc_ids"].shape[-1]),
                            b["doc_mask"].reshape(-1, b["doc_ids"].shape[-1]), "roberta.")
        d = d.view(q.shape[0], -1, q.shape[1])
        loss = ((q - t) ** 2).mean()
        for r in range(q.shape[0]):
            logits = [q[r] @ d[r, j] for j in range(d.shape[1])]
            m = max(float(x.detach()) for x in logits)
            loss = loss - (logits[0] - m - torch.log(sum(torch.exp(x - m) for x in logits))
                           ) / q.shape[0]
        assert float(loss) == pytest.approx(ref.losses[step], rel=1e-9)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        norm = math.sqrt(sum(float((g ** 2).sum()) for g in grads))
        scale = 1.0 if norm < mix["max_grad_norm"] else mix["max_grad_norm"] / norm
        lr = mix["learning_rate"] * (1 - step / mix["total_steps"])
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                g = g * scale
                mu[n] = B1 * mu[n] + (1 - B1) * g
                nu[n] = B2 * nu[n] + (1 - B2) * g * g
                p -= lr * (mu[n] / (1 - B1 ** (step + 1))) / (
                    torch.sqrt(nu[n] / (1 - B2 ** (step + 1))) + mix["adam_epsilon"])
    for n in w0:
        torch.testing.assert_close(ref.student[n].detach(), params[n].detach(),
                                   rtol=1e-9, atol=1e-12)
