"""The port's data-parallel train step and encode over S gloo ranks (S = 1,
2, 8) against the JAX mesh step over S of the conftest's virtual CPU
devices and against the port's single-process step on the global batch.

One spawn a world size (module scope) runs two KD + ranking steps on a
global batch of 8 and a data-parallel corpus encode, and writes rank 0's
results to an npz. Contracts, at S = 2 and 8: the first step's losses and
gradients within 5e-6 absolute of the JAX mesh step's (its loss
differentiated under the step's shardings; the tolerance of
``tests/test_torch_train.py``: f32 gradients of unit scale differ between
the packages by up to 3e-6) and of the port's single-process step, its
grad norm (about 18) within 1e-6 relative; the second step's metrics,
after the AdamW update on the all-reduced gradient, within the same
limits of the single-process step's. At S = 1 both steps equal the
unmeshed step bit for bit (each on one CPU thread, as the ranks run). The encode writes the
single-process run's rows in its order, within 1e-5 (another batch height
through the f32 products).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from convdr_torch.core import config as tcfg
from convdr_torch.core.loading import make_apply_fn
from convdr_torch.data.token_cache import TokenCache, TokenCacheWriter
from convdr_torch.models import encoders as tenc
from convdr_torch.models.from_jax import flax_params_to_state_dict
from convdr_torch.parallel.dryrun import run_cases, spawn
from convdr_torch.retrieval.blocks import load_embedding_block
from convdr_torch.retrieval.embed_corpus import generate_embeddings
from convdr_torch.train import trainer as ttr
from convdr_tpu.core.config import EncoderArchConfig, ModelConfig, TrainConfig
from convdr_tpu.models import encoders as jenc
from convdr_tpu.parallel.mesh import get_mesh
from convdr_tpu.train import losses as jl

WORLDS = [1, 2, 8]
JAX_WORLDS = [2, 8]
B, T, K_DOCS, DOC_LEN, STEPS = 8, 24, 3, 20, 2
CONFIG = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=K_DOCS - 1)
MODEL = ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=64),
                    embedding_dim=16)
ENCODE_BATCH, ENCODE_BUCKETS = 8, (8, 16)


def port_config(cfg):
    fields = dataclasses.asdict(cfg)
    if "arch" in fields:
        fields["arch"] = tcfg.EncoderArchConfig(**fields["arch"])
        return tcfg.ModelConfig(**fields)
    return tcfg.TrainConfig(**fields)


def _jax_apply(jmodel):
    def apply_fn(p, i, m, is_query):
        return jmodel.apply(p, i, m, method=jmodel.query_emb if is_query else jmodel.body_emb)
    return apply_fn


def _batches(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.randint(4, 60, size=(B, T)).astype(np.int32)
        mask = (np.arange(T)[None] < rng.randint(3, T + 1, size=B)[:, None]).astype(np.int32)
        tmask = (np.arange(12)[None] < rng.randint(2, 13, size=B)[:, None]).astype(np.int32)
        dmask = (np.arange(DOC_LEN) < rng.randint(1, DOC_LEN + 1, size=(B, K_DOCS, 1)))
        out.append({
            "concat_ids": ids * mask + (1 - mask), "concat_mask": mask,
            "target_ids": rng.randint(4, 60, size=(B, 12)).astype(np.int32),
            "target_mask": tmask,
            "doc_ids": rng.randint(4, 60, size=(B, K_DOCS, DOC_LEN)).astype(np.int32),
            "doc_mask": dmask.astype(np.int32),
        })
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = jenc.build_model(MODEL)
    ones = jnp.ones((1, 8), jnp.int32)
    params = [jmodel.init(jax.random.PRNGKey(seed), ones, ones) for seed in (0, 1)]
    states = [flax_params_to_state_dict(jax.tree.map(np.asarray, p), port_config(MODEL))
              for p in params]
    cache_dir = str(tmp_path_factory.mktemp("cache") / "passages")
    rng = np.random.RandomState(3)
    with TokenCacheWriter(cache_dir, 16) as w:
        for _ in range(37):  # a short last batch at every S
            n = rng.randint(2, 17)
            w.write(rng.randint(4, 60, size=n).tolist(), n)
    return {"jmodel": jmodel, "params": params, "states": states, "batches": _batches(0),
            "cache_dir": cache_dir}


def _model(state):
    model = tenc.build_model(port_config(MODEL))
    model.load_state_dict(state)
    return model


def _port_steps(setup):
    """The port's single-process steps on the global batches, on one
    thread as a rank computes (the CPU kernels' reductions split by
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _steps(setup)
    finally:
        torch.set_num_threads(threads)


def _steps(setup):
    student, teacher = (_model(s) for s in setup["states"])
    state, tx = ttr.create_train_state(student, port_config(CONFIG), 10)
    step = ttr.make_train_step(student, teacher, tx, port_config(CONFIG))
    metrics, grads = {}, None
    for n, batch in enumerate(setup["batches"]):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key, v in m.items():
            metrics.setdefault(key, []).append(float(v))
        if n == 0:
            grads = {name: p.grad.numpy().copy() for name, p in student.named_parameters()}
    return metrics, grads


@pytest.fixture(scope="module")
def unmeshed(setup, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("emb_single"))
    generate_embeddings(make_apply_fn(_model(setup["states"][0])), TokenCache(setup["cache_dir"]),
                        out_dir, device=torch.device("cpu"), batch_size=ENCODE_BATCH,
                        length_buckets=ENCODE_BUCKETS)
    return _port_steps(setup), out_dir


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    runs = {}

    def world(s):
        if s not in runs:
            tmp = tmp_path_factory.mktemp(f"ranks{s}")
            cases = {
                "train": ("train", dict(
                    model_config=port_config(MODEL), student_state=setup["states"][0],
                    teacher_state=setup["states"][1], train_config=port_config(CONFIG),
                    batches=setup["batches"])),
                "encode": ("encode", dict(
                    model_config=port_config(MODEL), state_dict=setup["states"][0],
                    cache_dir=setup["cache_dir"], out_dir=str(tmp / "emb"),
                    batch_size=ENCODE_BATCH, length_buckets=ENCODE_BUCKETS)),
            }
            spawn(s, run_cases, (cases, str(tmp / "out.npz")))
            with np.load(tmp / "out.npz") as f:
                runs[s] = dict(f), str(tmp / "emb")
        return runs[s]

    return world


def _jax_mesh_step(setup, s):
    """The JAX step's loss terms and gradients on the first batch over a
    mesh of S devices: its loss differentiated under the step's shardings
    (batch over ``data``, parameters replicated), so XLA inserts the same
    gradient all-reduce (the step itself returns no gradients)."""
    jmodel, (params, teacher) = setup["jmodel"], setup["params"]
    mesh = get_mesh(("data",), devices=jax.devices()[:s])
    apply_fn = _jax_apply(jmodel)

    def loss_fn(p, batch):
        embs = apply_fn(p, batch["concat_ids"], batch["concat_mask"], True)
        t = apply_fn(teacher, batch["target_ids"], batch["target_mask"], True)
        b, k, length = batch["doc_ids"].shape
        docs = apply_fn(teacher, batch["doc_ids"].reshape(b * k, length),
                        batch["doc_mask"].reshape(b * k, length), False)
        mse = jl.kd_mse_loss(embs, t)
        rank = jl.ranking_nll_loss(embs, docs.reshape(b, k, -1))
        return mse + rank, {"mse_loss": mse, "ranking_loss": rank}

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                      in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))))
    (loss, aux), grads = grad_fn(params, {k: jnp.asarray(v) for k, v in setup["batches"][0].items()})
    metrics = {"loss": loss, "grad_norm": optax.global_norm(grads), **aux}
    return ({k: float(v) for k, v in metrics.items()},
            flax_params_to_state_dict(jax.tree.map(np.asarray, grads), port_config(MODEL)))


def _close(got, want, key):
    """A step's metrics: losses within 5e-6 absolute, the norm (~18)
    within 1e-6 relative."""
    if key.startswith("grad_norm"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("n", JAX_WORLDS)
def test_dp_step_matches_jax_mesh_step(setup, worlds, n):
    got, _ = worlds(n)
    want, want_grads = _jax_mesh_step(setup, n)
    assert set(want) == {"loss", "mse_loss", "ranking_loss", "grad_norm"}
    for key, value in want.items():
        _close(got[f"train.{key}"][0], value, key)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got[f"train.grad.{name}"], g.numpy(), atol=5e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_dp_step_matches_single_process_step(worlds, unmeshed, n):
    got, _ = worlds(n)
    (metrics, grads), _ = unmeshed
    for key, values in metrics.items():
        if n == 1:
            np.testing.assert_array_equal(got[f"train.{key}"], values, err_msg=key)
        else:
            assert len(got[f"train.{key}"]) == len(values) == STEPS
            for step, (value, want) in enumerate(zip(got[f"train.{key}"], values)):
                _close(value, want, f"{key} of step {step + 1}")
    for name, g in grads.items():
        if n == 1:
            np.testing.assert_array_equal(got[f"train.grad.{name}"], g, err_msg=name)
        else:
            np.testing.assert_allclose(got[f"train.grad.{name}"], g, atol=5e-6, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_dp_encode_writes_the_single_process_blocks(worlds, unmeshed, n):
    got, emb_dir = worlds(n)
    _, want_dir = unmeshed
    rows, offsets = load_embedding_block(emb_dir, 0)
    want_rows, want_offsets = load_embedding_block(want_dir, 0)
    assert int(got["encode.rows"]) == want_rows.shape[0] == 37
    np.testing.assert_array_equal(offsets, want_offsets)
    np.testing.assert_allclose(rows, want_rows, atol=1e-5, rtol=0)
