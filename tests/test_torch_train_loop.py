"""The port's training loop and driver on the CPU.

``train_one_model`` against the JAX package's on one tiny topics file (the
same global step, the average loss to rtol 1e-4); resume from a
``checkpoint-N`` in either save format bit-identical to an uninterrupted
run; the guards; the
fold harness's output dirs; checkpoint detection; and the train driver end
to end, its output directory then read by the port's embed and inference
drivers.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.core.loading import load_model_and_params
from convdr_torch.data.conv_dataset import ConvSearchDataset as TorchDataset
from convdr_torch.data.token_cache import TokenCacheWriter, save_id_maps
from convdr_torch.data.tokenizers import ByteLevelBPETokenizer as TorchBPE
from convdr_torch.drivers import gen_passage_embeddings as torch_embed
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.drivers import run_convdr_train as torch_train
from convdr_torch.models import encoders as tenc
from convdr_torch.models.from_jax import flax_params_to_state_dict
from convdr_torch.parallel.dryrun import single_rank
from convdr_torch.parallel.mesh import get_mesh
from convdr_torch.train import checkpoint as tck
from convdr_torch.train import loop as tloop
from convdr_tpu.core.config import EncoderArchConfig, ModelConfig, TrainConfig
from convdr_tpu.data.conv_dataset import ConvSearchDataset as JaxDataset
from convdr_tpu.data.tokenizers import ByteLevelBPETokenizer as JaxBPE
from convdr_tpu.models import encoders as jenc
from convdr_tpu.train import loop as jloop

WORDS = "what about the history of jazz music in new orleans and blues".split()


def write_topics(path, n, seed=0, n_negs=4):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            turns = [" ".join(rng.choice(WORDS, rng.randint(2, 5))) for _ in range(1 + i % 3)]
            f.write(json.dumps({
                "topic_number": i, "query_number": len(turns), "input": turns,
                "target": turns[-1] + " jazz",
                "doc_pos": "title[SEP]" + " ".join(rng.choice(WORDS, rng.randint(2, 6))),
                "doc_negs": [" ".join(rng.choice(WORDS, rng.randint(1, 7)))
                             for _ in range(n_negs)],
            }) + "\n")
    return str(path)


CONFIG = dict(
    learning_rate=1e-3, ranking_task=True, num_negatives=2, per_device_batch_size=2,
    max_concat_length=40, max_query_length=16, max_doc_length=24, log_steps=1,
)


def _models(seed):
    tok = JaxBPE.tiny()
    cfg = ModelConfig(name="rdot_nll", arch=EncoderArchConfig.tiny(vocab_size=len(tok) + 8),
                      embedding_dim=16)
    jmodel = jenc.build_model(cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))
    pcfg = tcfg.ModelConfig(**{**cfg.__dict__, "arch": tcfg.EncoderArchConfig(**cfg.arch.__dict__)})
    tmodel = tenc.build_model(pcfg)
    tmodel.load_state_dict(flax_params_to_state_dict(jax.tree.map(np.asarray, params), pcfg))
    return jmodel, params, tmodel


def _jax_apply(jmodel):
    def apply_fn(p, i, m, is_query):
        return jmodel.apply(p, i, m, method=jmodel.query_emb if is_query else jmodel.body_emb)
    return apply_fn


def _torch_dataset(path):
    return TorchDataset([path], TorchBPE.tiny(), mode="train", ranking_task=True,
                        max_concat_length=40, max_query_length=16)


def test_train_one_model_matches_jax(tmp_path):
    topics = write_topics(tmp_path / "train.jsonl", 6)
    config = TrainConfig(num_train_epochs=1.5, **CONFIG)  # stops mid-epoch 2
    jmodel, jparams, student = _models(0)
    _, jteacher, teacher = _models(1)
    jds = JaxDataset([topics], JaxBPE.tiny(), mode="train", ranking_task=True,
                     max_concat_length=40, max_query_length=16)
    _, j_step, j_avg = jloop.train_one_model(
        jds, _jax_apply(jmodel), jparams, _jax_apply(jmodel), jteacher, config,
        tokenizer=JaxBPE.tiny(),
    )
    pconfig = tcfg.TrainConfig(**config.__dict__)
    _, t_step, t_avg = tloop.train_one_model(
        _torch_dataset(topics), student, teacher, pconfig, tokenizer=TorchBPE.tiny(),
    )
    assert t_step == j_step == 4
    np.testing.assert_allclose(t_avg, j_avg, rtol=1e-4)


class Preempted(RuntimeError):
    pass


def _dying_dataset(path, fail_after):
    ds = _torch_dataset(path)
    plain = ds.batches

    def batches(*args, **kw):
        for i, b in enumerate(plain(*args, **kw)):
            if i >= fail_after:
                raise Preempted("preempted")
            yield b

    ds.batches = batches
    return ds


@pytest.mark.parametrize("save_format", ["torch", "orbax"])
def test_resume_is_bit_identical(tmp_path, save_format):
    topics = write_topics(tmp_path / "train.jsonl", 8)
    config = tcfg.TrainConfig(num_train_epochs=2.0, save_steps=2, **CONFIG)

    class Recorder:
        def __init__(self):
            self.rows = []

        def log(self, step, means):
            self.rows.append((step, means["loss"]))

    def run(out_dir, resume=False, fail_after=None):
        rec = Recorder()
        _, _, student = _models(0)
        _, _, teacher = _models(1)
        ds = _torch_dataset(topics) if fail_after is None else _dying_dataset(topics, fail_after)
        model, step, _ = tloop.train_one_model(
            ds, student, teacher, config, tokenizer=TorchBPE.tiny(),
            output_dir=str(out_dir), metrics=rec, resume=resume, save_format=save_format,
        )
        return rec.rows, model, step

    full, full_model, full_step = run(tmp_path / "full")  # 8 steps
    with pytest.raises(Preempted):
        run(tmp_path / "resumed", fail_after=3)  # dies after checkpoint-2
    assert tck.latest_checkpoint(str(tmp_path / "resumed")).endswith("checkpoint-2")
    assert tck.load_metadata(str(tmp_path / "resumed" / "checkpoint-2")) == {"global_step": 2}
    written = set(os.listdir(tmp_path / "resumed" / "checkpoint-2"))
    assert ("train_state.pt" in written) == (save_format == "torch")
    assert ("_METADATA" in written) == (save_format == "orbax")
    tail, model, step = run(tmp_path / "resumed", resume=True)
    assert step == full_step == 8
    assert tail == [(s, v) for s, v in full if s > 2]
    for (name, a), b in zip(full_model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), name


def test_dataset_smaller_than_batch_raises(tmp_path):
    topics = write_topics(tmp_path / "t.jsonl", 3)
    _, _, student = _models(0)
    config = tcfg.TrainConfig(**{**CONFIG, "per_device_batch_size": 4})
    with pytest.raises(ValueError, match="needs 4"):
        tloop.train_one_model(_torch_dataset(topics), student, student, config)


def test_multi_device_batch_and_world1_mesh_train_as_one_process(tmp_path):
    """``n_devices`` multiplies the step's batch (the JAX rule); over a
    one-rank gloo mesh the loop trains bit for bit as without one, its rank
    writes the checkpoints, and a run preempted after checkpoint-2 resumes
    under the mesh to the same parameters."""
    topics = write_topics(tmp_path / "t.jsonl", 6)
    _, _, student = _models(0)
    with pytest.raises(ValueError, match=r"needs 12 \(per_device_batch_size=2 x 6 devices\)"):
        tloop.train_one_model(_torch_dataset(topics), student, student,
                              tcfg.TrainConfig(**CONFIG), n_devices=6)
    config = tcfg.TrainConfig(num_train_epochs=1.0, save_steps=2, **CONFIG)

    def run(out, mesh, dataset, resume=False):
        _, _, student = _models(0)
        _, _, teacher = _models(1)
        return tloop.train_one_model(dataset, student, teacher, config,
                                     tokenizer=TorchBPE.tiny(), output_dir=str(out),
                                     mesh=mesh, n_devices=1, resume=resume)

    want, want_step, want_avg = run(tmp_path / "plain", None, _torch_dataset(topics))
    with single_rank():
        mesh = get_mesh(("data",))
        got, got_step, got_avg = run(tmp_path / "mesh", mesh, _torch_dataset(topics))
        with pytest.raises(Preempted):
            run(tmp_path / "resumed", mesh, _dying_dataset(topics, 2))
        assert tck.latest_checkpoint(str(tmp_path / "resumed")).endswith("checkpoint-2")
        resumed, resumed_step, _ = run(tmp_path / "resumed", mesh, _torch_dataset(topics),
                                       resume=True)
    assert got_step == resumed_step == want_step == 3 and got_avg == want_avg
    assert tck.latest_checkpoint(str(tmp_path / "mesh")).endswith("checkpoint-2")
    for name, value in want.state_dict().items():
        assert torch.equal(got.state_dict()[name], value), name
        assert torch.equal(resumed.state_dict()[name], value), name


def test_fold_harness_output_dirs(tmp_path):
    base = tmp_path / "topics.jsonl"
    for fold in range(tcfg.NUM_FOLD):
        write_topics(f"{base}.{fold}", 2, seed=fold)
    config = tcfg.TrainConfig(**{**CONFIG, "max_steps": 1})
    _, _, teacher = _models(1)
    loaded = []

    def load_student(fold):
        loaded.append(fold)
        return TorchBPE.tiny(), _models(0)[2]

    out = str(tmp_path / "out")
    outputs = tloop.run_training(
        train_file=str(base), load_student=load_student, teacher=teacher, config=config,
        query_mode="no_res", model_type="rdot_nll", output_dir=out, cross_validate=True,
    )
    assert outputs == [f"{out}-{fold}" for fold in range(tcfg.NUM_FOLD)]
    assert loaded == [None] * tcfg.NUM_FOLD  # one init unless init_from_multiple_models
    for d in outputs:
        assert tck.load_metadata(os.path.join(d, "final")) == {
            "model_type": "rdot_nll", "global_step": 1}
        restored = tck.restore_checkpoint(os.path.join(d, "final"), _models(2)[2])
        assert isinstance(restored, torch.nn.Module)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len(f.readlines()) == tcfg.NUM_FOLD


# ---------------- checkpoint detection ----------------
def test_port_checkpoints_are_not_taken_for_orbax(tmp_path):
    _, tok, model = load_model_and_params("rdot_nll", None, device=torch.device("cpu"),
                                          arch_preset="tiny")
    torch.save(model.state_dict(), tmp_path / "pytorch_model.bin")
    tok.save_pretrained(str(tmp_path))
    tck.save_checkpoint(str(tmp_path / "final"), model, metadata={"model_type": "rdot_nll"})
    _, _, again = load_model_and_params("rdot_nll", str(tmp_path), device=torch.device("cpu"),
                                        arch_preset="tiny")
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_jax_orbax_tree_that_does_not_fit_raises_naming_the_key(tmp_path):
    from convdr_tpu.train.checkpoint import save_checkpoint as jax_save

    jax_save(str(tmp_path / "final"), {"w": np.zeros(3, np.float32)},
             metadata={"model_type": "rdot_nll"})
    TorchBPE.tiny().save_pretrained(str(tmp_path))
    with pytest.raises(ValueError, match="missing key 'params/backbone/"):
        load_model_and_params("rdot_nll", str(tmp_path), device=torch.device("cpu"),
                              arch_preset="tiny")


def test_jax_orbax_final_loads(tmp_path):
    from convdr_tpu.core.loading import load_model_and_params as jax_load
    from convdr_tpu.train.checkpoint import save_checkpoint as jax_save

    cfg, tok, _jmodel, params = jax_load("rdot_nll", "init", arch_preset="tiny", seed=2)
    jax_save(str(tmp_path / "final"), params, metadata={"model_type": "rdot_nll"})
    tok.save_pretrained(str(tmp_path))
    config, _, model = load_model_and_params("rdot_nll", str(tmp_path),
                                             device=torch.device("cpu"), arch_preset="tiny")
    want = flax_params_to_state_dict(jax.tree.map(np.asarray, params), config)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key


# ---------------- the driver ----------------
def _train_argv(tmp_path, *extra):
    topics = write_topics(tmp_path / "train.jsonl", 8, n_negs=6)
    return [
        "--output_dir", str(tmp_path / "model"), "--model_name_or_path", "init",
        "--train_file", topics, "--model_type", "rdot_nll", "--query", "no_res",
        "--ranking_task", "--num_negatives", "3", "--per_gpu_train_batch_size", "2",
        "--max_concat_length", "64", "--max_doc_length", "512", "--max_steps", "3",
        "--save_steps", "2", "--learning_rate", "1e-3", "--arch_size", "tiny", *extra,
    ]


def test_train_driver_end_to_end_then_inference(tmp_path, monkeypatch):
    trained = {}
    real = torch_train.run_training

    def keep_models(**kw):
        save = kw["save_fn"]

        def save_and_keep(model, out_dir, tok):
            save(model, out_dir, tok)
            trained[out_dir] = model

        return real(**{**kw, "save_fn": save_and_keep})

    monkeypatch.setattr(torch_train, "run_training", keep_models)
    out = str(tmp_path / "model")
    assert torch_train.main(_train_argv(tmp_path, "--no_cuda")) == [out]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert sorted(os.listdir(out)) == ["checkpoint-2", "merges.txt", "metrics.jsonl",
                                       "pytorch_model.bin", "vocab.json"]

    # the output dir loads, and its query encoder is the trained student
    _, tok, reloaded = load_model_and_params("rdot_nll", out, device=torch.device("cpu"),
                                             arch_preset="tiny")
    ids = torch.randint(5, 200, (3, 20), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(20)[None] < torch.tensor([[20], [9], [2]])).int()
    with torch.no_grad():
        assert torch.equal(reloaded.query_emb(ids, mask), trained[out].query_emb(ids, mask))

    # the port's embed and inference drivers read it
    processed, raw = tmp_path / "processed", tmp_path / "raw"
    os.makedirs(raw)
    os.makedirs(processed)
    with TokenCacheWriter(str(processed / "passages"), 64) as w:
        for i in range(12):
            w.write(tok.encode(" ".join(WORDS[i % 5: i % 5 + 4]), add_special_tokens=True))
    save_id_maps(str(processed), list(range(100, 112)))
    rows = torch_embed.main([
        "--data_dir", str(processed), "--checkpoint", out, "--model_type", "rdot_nll",
        "--output_dir", str(tmp_path / "emb"), "--per_gpu_eval_batch_size", "4",
        "--dtype", "float32", "--arch_size", "tiny", "--max_seq_length", "64", "--no_cuda",
    ])
    assert rows == 12
    with open(raw / "eval_topics.jsonl", "w") as f:
        f.write(json.dumps({"topic_number": 1, "query_number": 1, "input": ["jazz music"],
                            "target": "jazz music"}) + "\n")
    with open(raw / "queries.raw.tsv", "w") as f:
        f.write("1_1\tjazz music\n")
    with open(raw / "qrels.tsv", "w") as f:
        f.write("1_1\t0\t103\t1\n")
    means = torch_infer.main([
        "--model_path", out, "--eval_file", str(raw / "eval_topics.jsonl"),
        "--model_type", "rdot_nll", "--ann_data_dir", str(tmp_path / "emb"),
        "--processed_data_dir", str(processed), "--raw_data_dir", str(raw),
        "--qrels", str(raw / "qrels.tsv"), "--output_trec_file", str(tmp_path / "run.trec"),
        "--output_query_type", "raw", "--top_n", "5", "--arch_size", "tiny", "--no_cuda",
    ])
    assert "ndcg_cut_3" in means and "recall_5" in means
    assert all(0.0 <= v <= 1.0 for v in means.values())
    with open(tmp_path / "run.trec") as f:
        assert len(f.readlines()) == 5


def test_train_driver_needs_a_card_or_no_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no_cuda"):
        torch_train.main(_train_argv(tmp_path))


@pytest.mark.parametrize("flags", [["--use_dropout"], ["--dtype", "bfloat16"]])
def test_unported_train_options_raise(tmp_path, flags):
    """Both options raised NOT_PORTED once; each now trains the tiny model on
    the CPU to finite losses and an output dir that reloads."""
    out = str(tmp_path / "model")
    assert torch_train.main(_train_argv(tmp_path, "--no_cuda", *flags)) == [out]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 3 and all(np.isfinite(losses))
    dtype = torch.bfloat16 if "bfloat16" in flags else torch.float32
    _, _, reloaded = load_model_and_params("rdot_nll", out, device=torch.device("cpu"),
                                           dtype=dtype, arch_preset="tiny")
    ids = torch.randint(5, 200, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb = reloaded.query_emb(ids, torch.ones_like(ids))
    assert emb.shape == (2, 32) and bool(torch.isfinite(emb).all())


def test_clamps_follow_the_position_table():
    t_config = tcfg.ModelConfig(name="rdot_nll", arch=tcfg.EncoderArchConfig.tiny())
    config = tcfg.TrainConfig(max_concat_length=256, max_doc_length=512,
                              doc_length_buckets=(64, 128, 256, 384, 512))
    clamped = torch_train.clamp_lengths(config, t_config, "rdot_nll")
    assert clamped.max_concat_length == 130 and clamped.max_doc_length == 130
    assert clamped.doc_length_buckets == (64, 128, 130)
    mc = torch_train.clamp_lengths(
        tcfg.TrainConfig(max_doc_length=100),
        tcfg.ModelConfig(name="m", arch=tcfg.EncoderArchConfig.tiny(), chunk_len=32),
        "rdot_nll_multi_chunk",
    )
    assert mc.max_doc_length == 96
