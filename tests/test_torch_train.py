"""The port's training pieces against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages: losses (1e-6),
the learning-rate schedule at every step, the clipped AdamW chain with
masked weight decay and gradient accumulation against optax (1e-6), the
ranking-data pipeline (identical arrays), and whole KD + ranking train
steps from one JAX init converted with ``flax_params_to_state_dict``: the
per-step metrics over 5 steps agree to rtol 1e-4 and the first step's
gradients to 5e-6 absolute. The gradients' largest entries are about 1.9,
where f32 rounding alone separates the packages: over four seeded batches
they differ by 1.6e-6 to 3.0e-6 (10-25 ulps), and each package's gradients
stand within about 2e-6 of a float64 evaluation of the same step; 1e-6
would sit below that floor. JAX runs its CPU path (naive attention), the
port its plain attention; pads differ by design and never reach a loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from convdr_torch.core import config as tcfg
from convdr_torch.data.tokenizers import ByteLevelBPETokenizer as TorchBPE
from convdr_torch.models import encoders as tenc
from convdr_torch.models.from_jax import flax_params_to_state_dict
from convdr_torch.train import losses as tl
from convdr_torch.train import optimizer as topt
from convdr_torch.train import ranking_data as trd
from convdr_torch.train import trainer as ttr
from convdr_tpu.core.config import EncoderArchConfig, ModelConfig, TrainConfig
from convdr_tpu.data.tokenizers import ByteLevelBPETokenizer as JaxBPE
from convdr_tpu.models import encoders as jenc
from convdr_tpu.train import losses as jl
from convdr_tpu.train import optimizer as jopt
from convdr_tpu.train import ranking_data as jrd
from convdr_tpu.train import trainer as jtr


def port_config(cfg):
    fields = dataclasses.asdict(cfg)
    if "arch" in fields:
        fields["arch"] = tcfg.EncoderArchConfig(**fields["arch"])
        return tcfg.ModelConfig(**fields)
    return tcfg.TrainConfig(**fields)


# ---------------- losses ----------------
def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    b, k, c, e, chunk = 3, 4, 2, 8, 5
    q = rng.randn(b, e).astype(np.float32)
    mask = np.ones((b, c * chunk), np.int32)
    mask[0, chunk:] = 0  # an empty second chunk
    return {
        "q": q, "t": rng.randn(b, e).astype(np.float32),
        "docs": rng.randn(b, k, e).astype(np.float32),
        "pos": rng.randn(b, e).astype(np.float32), "neg": rng.randn(b, e).astype(np.float32),
        "pos_c": rng.randn(b, c, e).astype(np.float32),
        "neg_c": rng.randn(b, c, e).astype(np.float32), "mask": mask,
        "docs_c": rng.randn(b, k, c, e).astype(np.float32),
        "docs_mask": np.repeat(mask[:, None], k, axis=1), "chunk": chunk,
    }


LOSSES = {
    "kd_mse": lambda m, x: m.kd_mse_loss(x["q"], x["t"]),
    "ranking_nll": lambda m, x: m.ranking_nll_loss(x["q"], x["docs"]),
    "in_batch_nll": lambda m, x: m.in_batch_nll_loss(x["q"], x["pos"], x["neg"]),
    "in_batch_nll_multichunk": lambda m, x: m.in_batch_nll_multichunk_loss(
        x["q"], x["pos_c"], x["mask"], x["neg_c"], x["mask"], x["chunk"]),
    "ranking_nll_multichunk": lambda m, x: m.ranking_nll_multichunk_loss(
        x["q"], x["docs_c"], x["docs_mask"], x["chunk"]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    x = _loss_inputs(0)
    want = float(LOSSES[name](jl, {k: v if k == "chunk" else jnp.asarray(v) for k, v in x.items()}))
    got = LOSSES[name](tl, {k: v if k == "chunk" else torch.from_numpy(v) for k, v in x.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


def test_losses_detach_teacher_and_documents():
    x = _loss_inputs(1)
    q = torch.from_numpy(x["q"]).requires_grad_()
    t = torch.from_numpy(x["t"]).requires_grad_()
    docs = torch.from_numpy(x["docs"]).requires_grad_()
    (tl.kd_mse_loss(q, t) + tl.ranking_nll_loss(q, docs)).backward()
    assert q.grad is not None and t.grad is None and docs.grad is None


# ---------------- schedule and optimizer ----------------
@pytest.mark.parametrize("warmup,total", [(0, 12), (3, 12), (5, 5), (0, 1)])
def test_schedule_matches_optax_join_at_every_step(warmup, total):
    want = jopt.linear_warmup_decay(1e-3, warmup, total)
    got = topt.linear_warmup_decay(1e-3, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert got(0) == (1e-3 if warmup == 0 else 0.0)  # full rate on the first update
    if total > warmup:
        assert got(total) == 0.0


class Small(nn.Module):
    """Leaves named as the JAX tree below: a Linear, an Embedding, a
    LayerNorm named LayerNorm and one named norm (the ANCE head's)."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 3)
        self.emb = nn.Embedding(5, 3)
        self.LayerNorm = nn.LayerNorm(3)
        self.norm = nn.LayerNorm(3)


def _small_pair(seed):
    rng = np.random.RandomState(seed)
    tree = {
        "dense": {"kernel": rng.randn(4, 3), "bias": rng.randn(3)},
        "emb": {"embedding": rng.randn(5, 3)},
        "LayerNorm": {"scale": 1 + rng.randn(3) * 0.1, "bias": rng.randn(3)},
        "head_norm": {"scale": 1 + rng.randn(3) * 0.1, "bias": rng.randn(3)},
    }
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    model = Small()
    sd = {
        "dense.weight": tree["dense"]["kernel"].T, "dense.bias": tree["dense"]["bias"],
        "emb.weight": tree["emb"]["embedding"],
        "LayerNorm.weight": tree["LayerNorm"]["scale"], "LayerNorm.bias": tree["LayerNorm"]["bias"],
        "norm.weight": tree["head_norm"]["scale"], "norm.bias": tree["head_norm"]["bias"],
    }
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return tree, model


def _to_tree(named):
    """torch name -> value dict, in the JAX tree's layout."""
    return {
        "dense": {"kernel": named["dense.weight"].T, "bias": named["dense.bias"]},
        "emb": {"embedding": named["emb.weight"]},
        "LayerNorm": {"scale": named["LayerNorm.weight"], "bias": named["LayerNorm.bias"]},
        "head_norm": {"scale": named["norm.weight"], "bias": named["norm.bias"]},
    }


@pytest.mark.parametrize(
    "case",
    [
        dict(weight_decay=0.1, grad_scale=0.01),             # decay on, clip idle
        dict(weight_decay=0.1, grad_scale=5.0),              # clip active
        dict(weight_decay=0.0, grad_scale=5.0, accum=2),     # MultiSteps
        dict(weight_decay=0.01, grad_scale=0.3, accum=3, warmup=2),
    ],
)
def test_optimizer_matches_optax_chain(case):
    config = TrainConfig(
        learning_rate=1e-2, weight_decay=case["weight_decay"], max_grad_norm=1.0,
        warmup_steps=case.get("warmup", 0),
        gradient_accumulation_steps=case.get("accum", 1),
    )
    total = 6
    tree, model = _small_pair(0)
    tx = jopt.make_optimizer(config, total)
    jstate = tx.init(tree)
    jupdate = jax.jit(tx.update)
    params = dict(model.named_parameters())
    ttx = topt.make_optimizer(port_config(config), total, model)
    tstate = ttx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(8 * config.gradient_accumulation_steps):
        grads = {n: (rng.randn(*p.shape) * case["grad_scale"]).astype(np.float32)
                 for n, p in params.items()}
        upd, jstate = jupdate(_to_tree({n: jnp.asarray(g) for n, g in grads.items()}),
                                jstate, tree)
        tree = optax.apply_updates(tree, upd)
        ttx.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate, params)
        got = _to_tree({n: p.detach().numpy() for n, p in params.items()})
        for path, w in jax.tree_util.tree_leaves_with_path(tree):
            g = got
            for key in path:
                g = g[key.key]
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_decay_mask_by_module_type():
    cfg = port_config(ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=64),
                                  embedding_dim=16))
    mask = topt.decay_mask(tenc.build_model(cfg))
    assert mask["norm.weight"] is False  # the ANCE head's LayerNorm
    assert mask["norm.bias"] is False
    assert mask["roberta.encoder.layer.0.attention.output.LayerNorm.weight"] is False
    assert mask["roberta.embeddings.LayerNorm.weight"] is False
    assert mask["embeddingHead.bias"] is False
    assert mask["embeddingHead.weight"] is True
    assert mask["roberta.embeddings.word_embeddings.weight"] is True
    assert mask["roberta.encoder.layer.1.intermediate.dense.weight"] is True
    assert mask["roberta.encoder.layer.1.attention.self.query.weight"] is True


def test_clip_follows_optax_not_clip_grad_norm_():
    """Below max_norm the gradient passes untouched (torch's clip_grad_norm_
    would still scale by max / (norm + 1e-6))."""
    config = tcfg.TrainConfig(learning_rate=1.0, max_grad_norm=10.0)
    p = {"w": torch.zeros(2)}
    tx = topt.ClipAdamW(config, total_steps=1, decay={"w": True})
    state = tx.init(p)
    tx.update({"w": torch.tensor([3.0, 4.0])}, state, p)  # norm 5 < 10
    np.testing.assert_allclose(state["mu"]["w"].numpy(), [0.3, 0.4], rtol=1e-6)
    tx2 = topt.ClipAdamW(dataclasses.replace(config, max_grad_norm=1.0), total_steps=1,
                         decay={"w": True})
    state2 = tx2.init(p)
    tx2.update({"w": torch.tensor([3.0, 4.0])}, state2, p)  # scaled to norm 1
    np.testing.assert_allclose(state2["mu"]["w"].numpy(), [0.06, 0.08], rtol=1e-6)


# ---------------- ranking data ----------------
DOCS = [
    ["title[SEP]pos text one", "neg one", "neg two", "neg three", "neg four"],
    ["another positive doc", "n1", "n2 a bit longer", "n3"],
    ["pos only", "single neg"],  # short on negatives: sampled with replacement
]


@pytest.mark.parametrize("rungs", [None, (8, 16, 32, 48)])
def test_sample_ranking_batch_matches_jax(rungs):
    jcache = jrd.DocumentTokenizerCache(JaxBPE.tiny(), max_doc_length=48)
    tcache = trd.DocumentTokenizerCache(TorchBPE.tiny(), max_doc_length=48)
    for seed in range(3):
        want = jrd.sample_ranking_batch(DOCS, jcache, 3, np.random.RandomState(seed), rungs)
        got = trd.sample_ranking_batch(DOCS, tcache, 3, np.random.RandomState(seed), rungs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    if rungs:
        assert got[0].shape[-1] == 32


def test_document_cache_matches_jax_and_memoizes():
    jcache = jrd.DocumentTokenizerCache(JaxBPE.tiny(), max_doc_length=16)
    tcache = trd.DocumentTokenizerCache(TorchBPE.tiny(), max_doc_length=16, max_entries=2)
    for doc in ("title[SEP]body text", "a plain document that is long enough to cut"):
        for g, w in zip(tcache.encode(doc), jcache.encode(doc)):
            np.testing.assert_array_equal(g, w)
    assert tcache.encode("title[SEP]body text") is tcache.encode("title[SEP]body text")
    tcache.encode("third")
    tcache.encode("fourth")
    assert len(tcache._cache) == 2  # LRU bound


# ---------------- the train step ----------------
def _tiny_model_config(multi_chunk=False):
    return ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=64),
                       embedding_dim=16, multi_chunk=multi_chunk, chunk_len=8)


def _batches(seed, n, b=4, t=24, k=3, doc_len=20, multi_chunk=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(4, 60, size=(b, t)).astype(np.int32)
        lens = rng.randint(3, t + 1, size=b)
        mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
        tlen = rng.randint(2, 13, size=b)
        tmask = (np.arange(12)[None] < tlen[:, None]).astype(np.int32)
        dlen = rng.randint(1, doc_len + 1, size=(b, k, 1))
        if multi_chunk:  # chunks of 8; the second chunk of some docs empty
            dlen = np.minimum(dlen, np.where(rng.rand(b, k, 1) < 0.5, 8, doc_len))
        dmask = (np.arange(doc_len) < dlen).astype(np.int32)
        out.append({
            "concat_ids": ids * mask + (1 - mask), "concat_mask": mask,
            "target_ids": rng.randint(4, 60, size=(b, 12)).astype(np.int32),
            "target_mask": tmask,
            "doc_ids": rng.randint(4, 60, size=(b, k, doc_len)).astype(np.int32),
            "doc_mask": dmask,
        })
    return out


def _pair(cfg, seed):
    jmodel = jenc.build_model(cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))
    pcfg = port_config(cfg)
    tmodel = tenc.build_model(pcfg)
    tmodel.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), pcfg))
    return jmodel, params, tmodel


def _jax_apply(jmodel):
    def apply_fn(p, i, m, is_query):
        return jmodel.apply(p, i, m, method=jmodel.query_emb if is_query else jmodel.body_emb)
    return apply_fn


def _jax_step1_grads(jmodel, params, teacher_params, batch, config):
    """The JAX step's loss, differentiated on its own (its step returns no
    gradients)."""
    apply_fn = _jax_apply(jmodel)

    def loss_fn(p):
        embs = apply_fn(p, batch["concat_ids"], batch["concat_mask"], True)
        t = apply_fn(teacher_params, batch["target_ids"], batch["target_mask"], True)
        b, k, length = batch["doc_ids"].shape
        docs = apply_fn(teacher_params, batch["doc_ids"].reshape(b * k, length),
                        batch["doc_mask"].reshape(b * k, length), False)
        return jl.kd_mse_loss(embs, t) + jl.ranking_nll_loss(embs, docs.reshape(b, k, -1))

    return jax.jit(jax.grad(loss_fn))(params)


def _run_both(cfg, config, batches):
    jmodel, jparams, student = _pair(cfg, 0)
    _, jteacher, teacher = _pair(cfg, 1)
    state, tx = jtr.create_train_state(jparams, config, total_steps=10)
    jstep = jtr.make_train_step(_jax_apply(jmodel), _jax_apply(jmodel), tx, config)
    tstate, ttx = ttr.create_train_state(student, port_config(config), 10)
    tstep = ttr.make_train_step(student, teacher, ttx, port_config(config))
    jm, tm, grads = [], [], None
    for i, batch in enumerate(batches):
        state, m = jstep(state, jteacher, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        tm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in student.named_parameters()}
    return jm, tm, grads, (jmodel, jteacher, student)


def test_train_step_trajectory_and_gradients_match_jax():
    cfg = _tiny_model_config()
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2)
    batches = _batches(0, 5)
    # the JAX step donates its input state: take step-1 gradients first
    jmodel, jparams, _ = _pair(cfg, 0)
    _, jteacher, _ = _pair(cfg, 1)
    jgrads = _jax_step1_grads(jmodel, jparams, jteacher,
                              {k: jnp.asarray(v) for k, v in batches[0].items()}, config)
    jm, tm, tgrads, (_, _, student) = _run_both(cfg, config, batches)
    for step, (a, b) in enumerate(zip(jm, tm)):
        assert set(a) == set(b) == {"loss", "mse_loss", "ranking_loss", "grad_norm"}
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-4, err_msg=f"{key} @ {step}")
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), port_config(cfg))
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-6, rtol=0,
                                   err_msg=name)


def test_every_parameter_receives_a_gradient():
    cfg = _tiny_model_config()
    config = tcfg.TrainConfig(ranking_task=True, num_negatives=2)
    _, _, student = _pair(cfg, 0)
    _, _, teacher = _pair(cfg, 1)
    state, tx = ttr.create_train_state(student, config, 10)
    step = ttr.make_train_step(student, teacher, tx, config)
    step(state, {k: torch.from_numpy(v) for k, v in _batches(3, 1)[0].items()})
    assert student.training and not teacher.training
    names = [n for n, _ in student.named_parameters()]
    assert len(names) == len(list(student.parameters())) > 30
    for name, p in student.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if not name.endswith("attention.self.key.bias"):  # softmax-shift invariant
            assert p.grad.abs().max() > 0, name
    for must in ("roberta.embeddings.word_embeddings.weight",
                 "roberta.encoder.layer.1.output.LayerNorm.weight",
                 "embeddingHead.weight", "norm.weight", "norm.bias"):
        assert must in names
    assert all(p.grad is None for p in teacher.parameters())


def test_multi_chunk_ranking_step_matches_jax():
    cfg = _tiny_model_config(multi_chunk=True)
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2)
    jm, tm, _, _ = _run_both(cfg, config, _batches(1, 3, doc_len=16, multi_chunk=True))
    for a, b in zip(jm, tm):
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-4, err_msg=key)


def test_accumulated_steps_match_jax_multisteps():
    """k=2: the inner update runs on the mean of two micro-steps while each
    micro-step's metrics (grad_norm included) stay its own."""
    cfg = _tiny_model_config()
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2,
                         gradient_accumulation_steps=2, weight_decay=0.01)
    jm, tm, _, _ = _run_both(cfg, config, _batches(2, 4))
    for a, b in zip(jm, tm):
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-4, err_msg=key)


def test_grad_accumulation_updates_every_k_micro_steps():
    cfg = _tiny_model_config()
    config = tcfg.TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2)
    _, _, student = _pair(cfg, 0)
    _, _, teacher = _pair(cfg, 1)
    state, tx = ttr.create_train_state(student, config, 10)
    step = ttr.make_train_step(student, teacher, tx, config)
    batch = {k: torch.from_numpy(v) for k, v in _batches(4, 1)[0].items()}
    p0 = [p.detach().clone() for p in student.parameters()]
    step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(p0, student.parameters()))
    assert state.opt_state["count"] == 0 and state.step == 1
    step(state, batch)
    assert any(not torch.equal(a, b) for a, b in zip(p0, student.parameters()))
    assert state.opt_state["count"] == 1 and state.step == 2


def test_query_encode_fn_and_dropout_guard():
    cfg = _tiny_model_config()
    _, _, student = _pair(cfg, 0)
    encode = ttr.make_query_encode_fn(student)
    out = encode(torch.ones(2, 12, dtype=torch.int32), torch.ones(2, 12, dtype=torch.int32))
    assert out.shape == (2, 16) and not out.requires_grad
    # use_dropout raised NOT_PORTED once; now its step runs to a finite loss
    _, _, teacher = _pair(cfg, 1)
    config = tcfg.TrainConfig(use_dropout=True, ranking_task=True, num_negatives=2)
    state, tx = ttr.create_train_state(student, config, 10)
    _, metrics = ttr.make_train_step(student, teacher, tx, config)(
        state, {k: torch.from_numpy(v) for k, v in _batches(5, 1)[0].items()})
    assert bool(torch.isfinite(metrics["loss"]))
