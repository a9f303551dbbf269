"""convdr_torch encoders against the JAX package's on the same parameters.

JAX ``init`` -> numpy -> ``flax_params_to_state_dict`` -> the port, then
``query_emb`` / ``body_emb`` on the same ids and masks. Tolerance 1e-5
absolute in f32 (the same arithmetic in another summation order; the port's
attention takes the plain version on the CPU). The cases mirror
``tests/test_models.py``.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.models import encoders as tenc
from convdr_torch.models.from_jax import flax_params_to_state_dict
from convdr_tpu.core.config import EncoderArchConfig, ModelConfig
from convdr_tpu.models import encoders as jenc

ATOL = 1e-5


def tiny_config(multi_chunk=False, use_mean=False, chunk_len=16, gelu_tanh=False):
    arch = dataclasses.replace(
        EncoderArchConfig.tiny(vocab_size=64), gelu_approximate=gelu_tanh
    )
    return ModelConfig(
        name="test", arch=arch, embedding_dim=24, use_mean=use_mean,
        projection_head=True, multi_chunk=multi_chunk, chunk_len=chunk_len,
    )


def dpr_config():
    arch = EncoderArchConfig.tiny(vocab_size=64, roberta=False)
    return ModelConfig(name="dpr", arch=arch, projection_head=False,
                       two_tower=True, tokenizer_kind="bert")


def port_config(cfg: ModelConfig) -> tcfg.ModelConfig:
    fields = dataclasses.asdict(cfg)
    fields["arch"] = tcfg.EncoderArchConfig(**fields["arch"])
    return tcfg.ModelConfig(**fields)


def make_batch(seed, b=3, t=16, vocab=64, lengths=None):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, size=(b, t)).astype(np.int32)
    lens = rng.randint(2, t + 1, size=(b,)) if lengths is None else np.asarray(lengths)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    ids = ids * mask + 1 * (1 - mask)  # pad id 1
    return ids, mask


def both_models(cfg: ModelConfig, seed=0):
    jmodel = jenc.build_model(cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))
    params_np = jax.tree.map(np.asarray, params)
    tmodel = tenc.build_model(port_config(cfg))
    tmodel.load_state_dict(flax_params_to_state_dict(params_np, port_config(cfg)))
    return jmodel, params, tmodel.eval()


def jax_emb(jmodel, params, ids, mask, method):
    fn = getattr(jmodel, method)
    return np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=fn))


def torch_emb(tmodel, ids, mask, method):
    with torch.no_grad():
        return getattr(tmodel, method)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("method", ["query_emb", "body_emb"])
def test_ance_matches_jax(use_mean, method):
    cfg = tiny_config(use_mean=use_mean)
    jmodel, params, tmodel = both_models(cfg)
    ids, mask = make_batch(0)
    ours = torch_emb(tmodel, ids, mask, method)
    assert ours.shape == (3, 24) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, jax_emb(jmodel, params, ids, mask, method), atol=ATOL)


def test_ance_query_equals_body():
    _, _, tmodel = both_models(tiny_config())
    ids, mask = make_batch(1)
    np.testing.assert_array_equal(
        torch_emb(tmodel, ids, mask, "query_emb"), torch_emb(tmodel, ids, mask, "body_emb")
    )


def test_padding_invariance():
    _, _, tmodel = both_models(tiny_config())
    ids, mask = make_batch(2, b=1)
    ids2 = np.pad(ids, ((0, 0), (0, 8)), constant_values=1)
    mask2 = np.pad(mask, ((0, 0), (0, 8)))
    np.testing.assert_allclose(
        torch_emb(tmodel, ids, mask, "query_emb"),
        torch_emb(tmodel, ids2, mask2, "query_emb"), atol=ATOL,
    )


def test_multi_chunk_body_emb_with_empty_chunk_matches_jax():
    cfg = tiny_config(multi_chunk=True, chunk_len=16)
    jmodel, params, tmodel = both_models(cfg)
    ids, mask = make_batch(3, b=2)
    ids2 = np.concatenate([ids, ids], axis=1)
    mask2 = np.concatenate([mask, np.zeros_like(mask)], axis=1)  # empty chunk 1
    ours = torch_emb(tmodel, ids2, mask2, "body_emb")
    assert ours.shape == (2, 2, 24) and np.isfinite(ours).all()
    # The empty chunk is all pad positions, where segment-id attention and
    # the JAX naive path's key bias legitimately differ; scoring masks it
    # with CHUNK_MASK_BIAS. Only the real chunk is compared.
    ref = jax_emb(jmodel, params, ids2, mask2, "body_emb")
    np.testing.assert_allclose(ours[:, 0], ref[:, 0], atol=ATOL)
    single = torch_emb(tmodel, ids, mask, "body_emb")
    np.testing.assert_allclose(ours[:, 0], single[:, 0], atol=ATOL)


def test_multi_chunk_scores_match_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(3, 8).astype(np.float32)
    docs = rng.randn(3, 2, 8).astype(np.float32)
    docs[1, 1] *= 100  # huge score on an empty chunk must be masked
    mask = np.ones((3, 16), np.int32)
    mask[1, 8:] = 0
    ours = tenc.multi_chunk_scores(
        torch.from_numpy(q), torch.from_numpy(docs), torch.from_numpy(mask), 8
    ).numpy()
    ref = np.asarray(jenc.multi_chunk_scores(
        jnp.asarray(q), jnp.asarray(docs), jnp.asarray(mask), 8
    ))
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("method", ["query_emb", "body_emb"])
def test_dpr_matches_jax(method):
    cfg = dpr_config()
    jmodel, params, tmodel = both_models(cfg)
    ids, mask = make_batch(5)
    ours = torch_emb(tmodel, ids, mask, method)
    assert ours.shape == (3, cfg.arch.hidden_size)
    np.testing.assert_allclose(ours, jax_emb(jmodel, params, ids, mask, method), atol=ATOL)


def test_dpr_two_towers_differ():
    _, _, tmodel = both_models(dpr_config())
    ids, mask = make_batch(6)
    assert not np.allclose(
        torch_emb(tmodel, ids, mask, "query_emb"), torch_emb(tmodel, ids, mask, "body_emb")
    )


def test_gelu_tanh_matches_jax():
    cfg = tiny_config(gelu_tanh=True)
    jmodel, params, tmodel = both_models(cfg)
    ids, mask = make_batch(7)
    np.testing.assert_allclose(
        torch_emb(tmodel, ids, mask, "query_emb"),
        jax_emb(jmodel, params, ids, mask, "query_emb"), atol=ATOL,
    )


def test_pooling_helpers():
    seq = torch.arange(24, dtype=torch.float32).reshape(1, 4, 6)
    mask = torch.tensor([[1, 1, 0, 0]])
    assert tenc.masked_mean(seq, mask)[0, 0].item() == 3.0
    np.testing.assert_array_equal(tenc.pool(seq, mask, use_mean=False)[0].numpy(), np.arange(6.0))


def test_build_model_factory():
    assert isinstance(tenc.build_model(port_config(tiny_config())), tenc.AnceEncoder)
    assert isinstance(tenc.build_model(port_config(dpr_config())), tenc.DPRBiEncoder)


def test_gelu_arch_overrides_resolution():
    from convdr_torch.core.loading import gelu_arch_overrides

    assert gelu_arch_overrides("auto", "bfloat16") == {"gelu_approximate": True}
    assert gelu_arch_overrides("auto", "float32") is None
    assert gelu_arch_overrides("tanh", "float32") == {"gelu_approximate": True}
    assert gelu_arch_overrides("erf", "bfloat16") is None
    with pytest.raises(ValueError):
        gelu_arch_overrides("gelu", "float32")


def test_exported_hf_checkpoint_loads_with_same_outputs(tmp_path):
    """A reference-format ``pytorch_model.bin`` dir written by the JAX
    package's exporter loads into the port (tiny preset) with the JAX
    model's outputs."""
    from convdr_torch.core.loading import load_model_and_params
    from convdr_tpu.core.loading import load_model_and_params as jax_load
    from convdr_tpu.models.import_torch import export_ance_checkpoint

    jcfg, jtok, jmodel, params = jax_load("rdot_nll", None, arch_preset="tiny")
    export_ance_checkpoint(jax.tree.map(np.asarray, params), jcfg,
                           str(tmp_path / "pytorch_model.bin"))
    jtok.save_pretrained(str(tmp_path))
    cfg, tok, tmodel = load_model_and_params(
        "rdot_nll", str(tmp_path), device=torch.device("cpu"), arch_preset="tiny"
    )
    assert cfg.arch == tcfg.EncoderArchConfig(**dataclasses.asdict(jcfg.arch))
    assert tok.model_max_length == jtok.model_max_length
    ids, mask = make_batch(8, vocab=len(tok))
    np.testing.assert_allclose(
        torch_emb(tmodel, ids, mask, "query_emb"),
        jax_emb(jmodel, params, ids, mask, "query_emb"), atol=ATOL,
    )


def test_resize_token_embeddings_matches_jax():
    from convdr_torch.core.loading import resize_token_embeddings
    from convdr_tpu.core.loading import resize_token_embeddings as jax_resize

    table = np.random.RandomState(9).randn(5, 4).astype(np.float32)
    ours = resize_token_embeddings(
        {"roberta.embeddings.word_embeddings.weight": torch.from_numpy(table)}, 8, seed=3
    )["roberta.embeddings.word_embeddings.weight"].numpy()
    ref = jax_resize({"word_embeddings": {"embedding": table}}, 8, seed=3)
    np.testing.assert_array_equal(ours, ref["word_embeddings"]["embedding"])


def test_init_is_seeded_and_unported_checkpoints_raise(tmp_path):
    from convdr_torch.core.loading import load_model_and_params

    cpu = torch.device("cpu")
    a = load_model_and_params("rdot_nll", "init", device=cpu, arch_preset="tiny", seed=1)[2]
    b = load_model_and_params("rdot_nll", None, device=cpu, arch_preset="tiny", seed=1)[2]
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    (tmp_path / "convdr_meta.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model_and_params("rdot_nll", str(tmp_path), device=cpu,
                              tokenizer_path="tiny", arch_preset="tiny")
    # dpr checkpoints are ported: a file that is no checkpoint fails to load
    ckpt = tmp_path / "dpr.cp"
    ckpt.write_bytes(b"x")
    with pytest.raises(pickle.UnpicklingError):
        load_model_and_params("dpr", str(ckpt), device=cpu, tokenizer_path="tiny",
                              arch_preset="tiny")


def test_bf16_compute_keeps_layernorm_f32():
    from convdr_torch.core.loading import load_model_and_params

    _, _, model = load_model_and_params(
        "rdot_nll", None, device=torch.device("cpu"), arch_preset="tiny",
        dtype=torch.bfloat16,
    )
    assert model.roberta.embeddings.word_embeddings.weight.dtype == torch.bfloat16
    assert model.embeddingHead.weight.dtype == torch.bfloat16
    assert model.norm.weight.dtype == torch.float32
    ids, mask = make_batch(10, vocab=200)
    out = torch_emb(model, ids, mask, "query_emb")
    assert out.dtype == np.float32 and np.isfinite(out).all()
