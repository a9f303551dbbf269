"""bf16 training in the port against the JAX package's bf16 step (CPU).

Both packages compute in bf16 over f32 master parameters: flax's modules
under ``dtype=bf16``, the port's student through ``cast_at_use``. From one
JAX init the same batches go through five KD + ranking steps in each. The
two round in different places (the port keeps P V's probabilities in f32,
gathers embedding rows before their cast, fuses a linear layer's bias), so
the checks are held to the JAX package's own bf16 error:

  * each step's loss within rtol 1e-2 (bf16 keeps 8 bits), and the MSE and
    ranking parts of step 1 (the same parameters) too;
  * step-1 gradients, for every parameter: ``|g_port - g_f64| <= 2 |g_jax
    - g_f64| + 1e-6 |g_f64|``, where ``g_f64`` is the port's plain step run
    wholly in float64 and each norm is taken over the gradients at the init
    of all five batches (Frobenius, pooled): one batch's bf16 error is a few
    percent of the gradient and as likely to favour either package (the
    median ratio over parameters was 0.6-1.6 on ten seeded batches), so a
    single batch puts 2x within chance (twice in those ten: 2.28, 2.38),
    and pooling keeps it out (at most 1.67x over four batches);
  * parameters, gradients and optimizer moments stay f32.

A bf16-trained student saved by the port reloads for bf16 inference and
encodes exactly as the in-memory student does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core.loading import load_model_and_params
from convdr_torch.models import encoders as tenc
from convdr_torch.models.from_jax import flax_params_to_state_dict
from convdr_torch.models.transformer import cast_at_use, to_compute_dtype
from convdr_torch.train import trainer as ttr
from convdr_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from convdr_tpu.core.config import TrainConfig
from convdr_tpu.models import encoders as jenc
from convdr_tpu.train import losses as jl
from convdr_tpu.train import trainer as jtr
from test_torch_train import _batches, _tiny_model_config, port_config

BF16 = torch.bfloat16
STEPS = 5


def _init(cfg, seed):
    """One JAX init (f32 params) and the bf16 flax module over it."""
    jmodel = jenc.build_model(cfg, dtype=jnp.bfloat16)
    ids = jnp.ones((1, 8), jnp.int32)
    return jmodel, jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))


def _port_model(cfg, params, dtype, master=True):
    """The port's model on the JAX params: f32 masters cast at use (the
    student), or parameters cast to ``dtype`` (the teacher)."""
    pcfg = port_config(cfg)
    model = tenc.build_model(pcfg)
    model.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), pcfg))
    if dtype == torch.float64:
        return model.double()
    return cast_at_use(model, dtype) if master else to_compute_dtype(model, dtype)


def _apply(jmodel):
    def apply_fn(p, i, m, is_query):
        return jmodel.apply(p, i, m, method=jmodel.query_emb if is_query else jmodel.body_emb)
    return apply_fn


def _jax_grads(jmodel, params, teacher_params, batch):
    """The JAX step's loss (KD + ranking, multi-chunk documents as the step
    scores them), differentiated on its own."""
    apply_fn = _apply(jmodel)

    def loss_fn(p):
        embs = apply_fn(p, batch["concat_ids"], batch["concat_mask"], True)
        t = apply_fn(teacher_params, batch["target_ids"], batch["target_mask"], True)
        b, k, length = batch["doc_ids"].shape
        docs = apply_fn(teacher_params, batch["doc_ids"].reshape(b * k, length),
                        batch["doc_mask"].reshape(b * k, length), False)
        if docs.ndim == 3:
            c = docs.shape[1]
            rank = jl.ranking_nll_multichunk_loss(embs, docs.reshape(b, k, c, -1),
                                                  batch["doc_mask"], length // c)
        else:
            rank = jl.ranking_nll_loss(embs, docs.reshape(b, k, -1))
        return jl.kd_mse_loss(embs, t) + rank

    return jax.jit(jax.grad(loss_fn))(params)


def _port_run(cfg, config, jparams, jteacher, batches, dtype):
    student = _port_model(cfg, jparams, dtype)
    teacher = _port_model(cfg, jteacher, dtype, master=False)
    teacher.requires_grad_(False)
    state, tx = ttr.create_train_state(student, port_config(config), 10)
    step = ttr.make_train_step(student, teacher, tx, port_config(config))
    losses, grads = [], None
    for i, batch in enumerate(batches):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in student.named_parameters()}
    return losses, grads, student, state


@pytest.mark.parametrize("multi_chunk", [False, True])
def test_bf16_steps_match_the_jax_bf16_step(multi_chunk):
    cfg = _tiny_model_config(multi_chunk=multi_chunk)
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2)
    batches = _batches(6, STEPS, doc_len=16, multi_chunk=multi_chunk)
    jmodel, jparams = _init(cfg, 0)
    _, jteacher = _init(cfg, 1)
    # the error of each package's step-1 gradients from the f64 step's,
    # pooled over the batches (the JAX step donates its input state: its
    # gradients are taken first)
    err2 = {"port": {}, "jax": {}, "f64": {}}
    for batch in batches:
        jg = _jax_grads(jmodel, jparams, jteacher, {k: jnp.asarray(v) for k, v in batch.items()})
        jg = flax_params_to_state_dict(jax.tree.map(np.asarray, jg), port_config(cfg))
        _, tg, _, _ = _port_run(cfg, config, jparams, jteacher, [batch], BF16)
        _, xg, _, _ = _port_run(cfg, config, jparams, jteacher, [batch], torch.float64)
        for name, x in xg.items():
            for side, g in (("port", tg[name].double() - x), ("jax", jg[name].double() - x),
                            ("f64", x)):
                err2[side][name] = err2[side].get(name, 0.0) + float(g.norm()) ** 2
        assert all(g.dtype == torch.float32 for g in tg.values())

    state, tx = jtr.create_train_state(jparams, config, total_steps=10)
    jstep = jtr.make_train_step(_apply(jmodel), _apply(jmodel), tx, config)
    jlosses = []
    for batch in batches:
        state, m = jstep(state, jteacher, {k: jnp.asarray(v) for k, v in batch.items()})
        jlosses.append({k: float(v) for k, v in m.items()})
    assert all(leaf.dtype == jnp.float32 for leaf in jax.tree.leaves(state.params))

    _, jparams = _init(cfg, 0)
    tlosses, _, student, tstate = _port_run(cfg, config, jparams, jteacher, batches, BF16)

    for step, (a, b) in enumerate(zip(jlosses, tlosses)):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-2, err_msg=f"loss @ {step}")
    for key in ("mse_loss", "ranking_loss"):  # the same parameters at step 1
        np.testing.assert_allclose(tlosses[0][key], jlosses[0][key], rtol=1e-2, err_msg=key)
    for name in err2["f64"]:
        port_err, jax_err, scale = (err2[side][name] ** 0.5 for side in ("port", "jax", "f64"))
        assert port_err <= 2 * jax_err + 1e-6 * scale, (name, port_err, jax_err)
    assert all(p.dtype == torch.float32 for p in student.parameters())
    assert all(t.dtype == torch.float32 for t in tstate.opt_state["mu"].values())
    assert all(t.dtype == torch.float32 for t in tstate.opt_state["nu"].values())


def test_bf16_student_checkpoint_reloads_for_bf16_inference(tmp_path):
    """The driver's loaders: a student with f32 masters computing in bf16
    and a bf16 teacher; two steps, then the checkpoint and the HF-layout
    file it writes hold the f32 masters, and the file reloads for bf16
    inference encoding exactly as the in-memory student does."""
    cpu = torch.device("cpu")
    _, _, student = load_model_and_params("rdot_nll", "init", device=cpu, dtype=BF16,
                                          f32_params=True, arch_preset="tiny", seed=3)
    _, _, teacher = load_model_and_params("rdot_nll", "init", device=cpu, dtype=BF16,
                                          arch_preset="tiny", seed=4)
    teacher.requires_grad_(False)
    config = port_config(TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2))
    state, tx = ttr.create_train_state(student, config, 10)
    step = ttr.make_train_step(student, teacher, tx, config)
    for batch in _batches(7, 2):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert bool(torch.isfinite(m["loss"]))
    save_checkpoint(str(tmp_path / "ckpt"), state)
    torch.save({k: v.float() for k, v in student.state_dict().items()},
               str(tmp_path / "pytorch_model.bin"))
    template = load_model_and_params("rdot_nll", "init", device=cpu, dtype=BF16,
                                     f32_params=True, arch_preset="tiny")[2]
    restored = restore_checkpoint(str(tmp_path / "ckpt"), template)
    for (name, a), b in zip(student.state_dict().items(), restored.state_dict().values()):
        assert a.dtype == torch.float32 and torch.equal(a, b), name
    _, _, bf16 = load_model_and_params("rdot_nll", str(tmp_path), device=cpu, dtype=BF16,
                                       tokenizer_path="tiny", arch_preset="tiny")
    ids = torch.randint(4, 60, (3, 20), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(20)[None] < torch.tensor([[20], [9], [2]])).int()
    student.eval()
    with torch.no_grad():
        assert torch.equal(bf16.query_emb(ids, mask), student.query_emb(ids, mask))
