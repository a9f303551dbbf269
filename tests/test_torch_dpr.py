"""dpr checkpoints in convdr_torch against the JAX package's importer.

One tiny dpr model is saved three ways: a DPR ``CheckpointState`` file
(``{"model_dict": {"question_model.*", "ctx_model.*"}, ...}``), an HF-style
dir whose towers hold ``bert.*`` keys, and the port's own training output
(a flat ``DPRBiEncoder.state_dict()`` in ``pytorch_model.bin``). Each goes
through ``convdr_tpu.models.import_torch.import_dpr_checkpoint`` and through
the port's ``load_model_and_params("dpr", ...)``; ``query_emb`` and
``body_emb`` agree within 1e-5 absolute in f32 (the same arithmetic in
another summation order). Then the port's tiny dpr train -> embed ->
inference chain runs on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convdr_torch.core import config as tcfg
from convdr_torch.core.loading import load_model_and_params
from convdr_torch.data.token_cache import TokenCacheWriter, save_id_maps
from convdr_torch.drivers import gen_passage_embeddings as torch_embed
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.drivers import run_convdr_train as torch_train
from convdr_tpu.core.loading import load_model_and_params as jax_load
from convdr_tpu.models.import_torch import import_dpr_checkpoint

ATOL = 1e-5
CPU = torch.device("cpu")
WORDS = "what about the history of jazz music in new orleans and blues".split()


def make_batch(seed, vocab, b=3, t=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, size=(b, t)).astype(np.int32)
    lens = np.asarray([t, 9, 2])[:b]
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def save_dpr(model, path, layout):
    """The port's tiny dpr model's weights, written in one of the layouts
    a dpr checkpoint comes in; -> the path to load from."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if layout == "checkpoint_state":
        path = os.path.join(path, "dpr.cp")
        torch.save({"model_dict": sd, "optimizer_dict": None, "scheduler_dict": None,
                    "offset": 0, "epoch": 1, "encoder_params": {"pretrained": "tiny"}}, path)
        return path
    if layout == "hf_dir":
        sd = {k.replace("question_model.", "question_model.bert.")
              .replace("ctx_model.", "ctx_model.bert."): v for k, v in sd.items()}
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    return path


@pytest.mark.parametrize("layout", ["checkpoint_state", "hf_dir", "port_output"])
@pytest.mark.parametrize("method", ["query_emb", "body_emb"])
def test_dpr_checkpoint_loads_as_in_jax(tmp_path, layout, method):
    _, _, source = load_model_and_params("dpr", "init", device=CPU, arch_preset="tiny", seed=3)
    path = save_dpr(source, str(tmp_path), layout)
    jcfg, jtok, jmodel, _ = jax_load("dpr", None, arch_preset="tiny")
    cfg, tok, tmodel = load_model_and_params("dpr", path, device=CPU, tokenizer_path="tiny",
                                             arch_preset="tiny")
    assert cfg.arch == tcfg.EncoderArchConfig(**dataclasses.asdict(jcfg.arch))
    params = import_dpr_checkpoint(path, jcfg)
    ids, mask = make_batch(1, len(tok))
    with torch.no_grad():
        ours = getattr(tmodel, method)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        want = getattr(source, method)(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                  jnp.asarray(mask), method=getattr(jmodel, method)))
    assert ours.shape == (3, cfg.arch.hidden_size)
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_array_equal(ours, want)  # the same weights, the same code


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


def test_dpr_train_embed_inference_chain(tmp_path, monkeypatch):
    """The port's tiny dpr ``run_convdr_train`` output reloads as the
    trained student and feeds ``gen_passage_embeddings`` and
    ``run_convdr_inference``, which write a run file."""
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
    topics = write_topics(tmp_path / "train.jsonl", 8, n_negs=6)
    assert torch_train.main([
        "--output_dir", out, "--model_name_or_path", "init", "--train_file", topics,
        "--model_type", "dpr", "--query", "no_res", "--ranking_task", "--num_negatives", "3",
        "--per_gpu_train_batch_size", "2", "--max_concat_length", "64",
        "--max_doc_length", "128", "--max_steps", "2", "--learning_rate", "1e-3",
        "--arch_size", "tiny", "--no_cuda",
    ]) == [out]
    assert os.path.exists(os.path.join(out, "vocab.txt"))

    _, tok, reloaded = load_model_and_params("dpr", out, device=CPU, arch_preset="tiny")
    ids = torch.randint(5, len(tok), (3, 20), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(20)[None] < torch.tensor([[20], [9], [2]])).int()
    with torch.no_grad():
        for method in ("query_emb", "body_emb"):
            assert torch.equal(getattr(reloaded, method)(ids, mask),
                               getattr(trained[out], method)(ids, mask)), method

    processed, raw = tmp_path / "processed", tmp_path / "raw"
    os.makedirs(raw)
    os.makedirs(processed)
    with TokenCacheWriter(str(processed / "passages"), 64) as w:
        for i in range(12):
            w.write(tok.encode(" ".join(WORDS[i % 5: i % 5 + 4]), add_special_tokens=True))
    save_id_maps(str(processed), list(range(100, 112)))
    rows = torch_embed.main([
        "--data_dir", str(processed), "--checkpoint", out, "--model_type", "dpr",
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
        "--model_type", "dpr", "--ann_data_dir", str(tmp_path / "emb"),
        "--processed_data_dir", str(processed), "--raw_data_dir", str(raw),
        "--qrels", str(raw / "qrels.tsv"), "--output_trec_file", str(tmp_path / "run.trec"),
        "--output_query_type", "raw", "--top_n", "5", "--arch_size", "tiny", "--no_cuda",
    ])
    assert "ndcg_cut_3" in means and all(0.0 <= v <= 1.0 for v in means.values())
    with open(tmp_path / "run.trec") as f:
        assert len(f.readlines()) == 5
