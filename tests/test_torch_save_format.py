"""The port's train driver under ``--save_format orbax`` against the JAX
package's driver, on the CPU.

Both drivers take the same argv (tiny models, 3 steps, ``--save_steps 2``)
from one JAX-written initial dir per model type, so they start from the
same weights:

* (a) the output dirs have the same top-level listing, ``checkpoint-2/``
  and ``final/`` hold orbax's metadata files with equal ``convdr_meta.json``
  and ``_METADATA`` (OCDBT data files have random names and are not
  compared), for ``rdot_nll`` and ``dpr`` with and without
  ``--export_torch``;
* (b) the JAX driver's ``--resume`` continues the port's ``checkpoint-2``
  exactly as it continues the same state saved by the JAX package, and
  within 5e-6 of the uninterrupted JAX run (``tests/test_torch_train.py``'s
  bound), with and without gradient accumulation;
* (c) the JAX ``load_model_and_params`` reads the port's ``final/`` bitwise;
* (d) ``--export_torch`` writes the JAX ``export_ance_checkpoint`` of the
  same parameters;
* (e) under ``--dtype bfloat16`` the arrays keep the JAX run's dtypes (the
  f32 masters).
"""

import json
import os
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from convdr_torch.drivers import run_convdr_train as torch_train
from convdr_torch.models.from_jax import state_dict_to_flax
from convdr_tpu.core.config import TrainConfig
from convdr_tpu.core.loading import load_model_and_params as jax_load
from convdr_tpu.drivers import run_convdr_train as jax_train
from convdr_tpu.models.import_torch import export_ance_checkpoint
from convdr_tpu.train import trainer as jtr
from convdr_tpu.train.checkpoint import restore_checkpoint as jax_restore
from convdr_tpu.train.checkpoint import save_checkpoint as jax_save
from test_torch_train_loop import write_topics

ORBAX_FILES = {"_CHECKPOINT_METADATA", "_METADATA", "convdr_meta.json"}
# the attention key biases' true gradient is zero (a per-query constant
# under the softmax), so Adam turns each package's rounding into full steps
KEY_BIAS = "['attention']['key']['bias']"


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


class Runs:
    """Driver runs in one work dir, each made once: ``(package, model_type,
    *flags)`` -> (output dir, the port's trained student or None)."""

    def __init__(self, work):
        self.work = work
        self.done = {}
        write_topics(work / "train.jsonl", 8, n_negs=6)
        for model_type in ("rdot_nll", "dpr"):
            _cfg, tok, _model, params = jax_load(model_type, "init", arch_preset="tiny", seed=7)
            jax_save(str(work / f"init_{model_type}" / "final"), params,
                     metadata={"model_type": model_type})
            tok.save_pretrained(str(work / f"init_{model_type}"))

    def argv(self, out, model_type, *flags):
        return ["--output_dir", str(out), "--model_name_or_path",
                str(self.work / f"init_{model_type}"), "--train_file",
                str(self.work / "train.jsonl"), "--model_type", model_type, "--query", "no_res",
                "--ranking_task", "--num_negatives", "3", "--per_gpu_train_batch_size", "2",
                "--max_concat_length", "64", "--max_doc_length", "512", "--max_steps", "3",
                "--save_steps", "2", "--learning_rate", "1e-3", "--arch_size", "tiny", *flags]

    def __call__(self, package, model_type, *flags):
        key = (package, model_type, *flags)
        if key not in self.done:
            out = self.work / f"run{len(self.done)}"
            argv = self.argv(out, model_type, *flags)
            student = None
            if package == "jax":
                jax_train.main(argv + ["--no_mesh"])
            else:
                kept = {}
                real = torch_train.run_training

                def keep(**kw):
                    save = kw["save_fn"]

                    def save_and_keep(model, out_dir, tok):
                        save(model, out_dir, tok)
                        kept["student"] = model

                    return real(**{**kw, "save_fn": save_and_keep})

                torch_train.run_training = keep
                try:
                    torch_train.main(argv + ["--save_format", "orbax", "--no_cuda"])
                finally:
                    torch_train.run_training = real
                student = kept["student"]
            self.done[key] = (out, student)
        return self.done[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(tmp_path_factory.mktemp("save_format"))


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _metrics(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("export", [False, True], ids=["plain", "export_torch"])
@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
def test_orbax_layout_equals_the_jax_driver(runs, model_type, export):
    flags = ("--export_torch",) if export else ()
    jax_out, _ = runs("jax", model_type, *flags)
    port_out, _ = runs("torch", model_type, *flags)
    listing = sorted(os.listdir(jax_out))
    assert sorted(os.listdir(port_out)) == listing
    assert ("pytorch_model.bin" in listing) == (export and model_type == "rdot_nll")
    assert {"checkpoint-2", "final", "metrics.jsonl"} <= set(listing)
    for sub in ("checkpoint-2", "final"):
        assert ORBAX_FILES <= set(os.listdir(port_out / sub))
        assert "train_state.pt" not in os.listdir(port_out / sub)
        for name in ("convdr_meta.json", "_METADATA"):
            assert _read_json(port_out / sub / name) == _read_json(jax_out / sub / name), \
                (sub, name)
        want = _read_json(jax_out / sub / "_CHECKPOINT_METADATA")
        got = _read_json(port_out / sub / "_CHECKPOINT_METADATA")
        assert got.keys() == want.keys() and got["item_handlers"] == want["item_handlers"]
    assert _read_json(port_out / "checkpoint-2" / "convdr_meta.json") == {"global_step": 2}
    assert _read_json(port_out / "final" / "convdr_meta.json") == {"model_type": model_type}
    assert [r["step"] for r in _metrics(port_out)] == [r["step"] for r in _metrics(jax_out)]


def _params_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("accum", [1, 2])
def test_jax_driver_resumes_the_port_run(runs, accum):
    """The port writes ``checkpoint-2``; the JAX driver's ``--resume`` runs
    step 3 from it (a) exactly as from the same state saved by the JAX
    package, and (b) within 5e-6 of the uninterrupted JAX run: the step-3
    losses, and every final parameter beyond what the two runs' own first
    two steps already put apart in ``checkpoint-2`` (the key biases, whose
    step is rounding that Adam normalises, are held by (a) alone)."""
    flags = ("--gradient_accumulation_steps", "2") if accum == 2 else ()
    jax_out, _ = runs("jax", "rdot_nll", *flags)
    port_out, _ = runs("torch", "rdot_nll", *flags)
    init = _np(jax_load("rdot_nll", str(runs.work / "init_rdot_nll"), arch_preset="tiny")[3])
    template, _ = jtr.create_train_state(init, TrainConfig(gradient_accumulation_steps=accum),
                                         10)
    port_state = jax_restore(str(port_out / "checkpoint-2"), template)
    resumed = {}
    for name in ("port_dir", "jax_resaved"):
        out = runs.work / f"resume{accum}_{name}"
        if name == "port_dir":
            shutil.copytree(port_out / "checkpoint-2", out / "checkpoint-2")
        else:
            jax_save(str(out / "checkpoint-2"), port_state, metadata={"global_step": 2})
        jax_train.main(runs.argv(out, "rdot_nll", *flags, "--resume", "--no_mesh"))
        rows = _metrics(out)
        assert [r["step"] for r in rows] == [3]
        resumed[name] = (rows[0], _params_by_path(jax_restore(str(out / "final"), init)))

    (row, final), (row_js, final_js) = resumed["port_dir"], resumed["jax_resaved"]
    assert {k: v for k, v in row.items() if k != "time"} == \
        {k: v for k, v in row_js.items() if k != "time"}
    assert final.keys() == final_js.keys()
    for name, value in final.items():
        assert np.array_equal(value, final_js[name]), name

    want_row = _metrics(jax_out)[-1]
    assert want_row["step"] == 3
    for key in ("loss", "mse_loss", "ranking_loss"):
        np.testing.assert_allclose(row[key], want_row[key], atol=5e-6, rtol=0, err_msg=key)
    want = _params_by_path(jax_restore(str(jax_out / "final"), init))
    drift_port = _params_by_path(port_state.params)
    drift_jax = _params_by_path(jax_restore(str(jax_out / "checkpoint-2"), template).params)
    assert want.keys() == final.keys()
    checked = 0
    for name, value in want.items():
        if KEY_BIAS in name:
            continue
        drift = np.abs(drift_port[name] - drift_jax[name])
        assert np.all(np.abs(final[name] - value) <= 5e-6 + drift), name
        checked += 1
    assert checked == len(want) - 2  # two layers' key biases


def test_jax_reads_the_port_final_bitwise(runs):
    for model_type in ("rdot_nll", "dpr"):
        out, student = runs("torch", model_type)
        params = _params_by_path(_np(jax_load(model_type, str(out), arch_preset="tiny")[3]))
        mine = _params_by_path(jax.tree.map(lambda t: t.numpy(),
                                            state_dict_to_flax(student.state_dict(),
                                                               student.config)))
        assert params.keys() == mine.keys() and params
        for name, value in mine.items():
            assert params[name].dtype == value.dtype and np.array_equal(params[name], value), \
                (model_type, name)


def test_export_torch_is_the_jax_export_of_the_same_params(runs, tmp_path):
    out, student = runs("torch", "rdot_nll", "--export_torch")
    cfg, _tok, _model, params = jax_load("rdot_nll", str(out), arch_preset="tiny")
    export_ance_checkpoint(_np(params), cfg, str(tmp_path / "jax.bin"))
    want = torch.load(tmp_path / "jax.bin", weights_only=True)
    got = torch.load(out / "pytorch_model.bin", weights_only=True)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    for key, value in student.state_dict().items():
        assert torch.equal(got[key], value.float()), key


def _zarray_dtypes(path):
    """{array: zarr dtype} of the orbax dir at ``path``, read by tensorstore."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}"}).result()
    return {k.decode()[:-len("/.zarray")]: json.loads(kv.read(k).result().value)["dtype"]
            for k in kv.list().result() if k.endswith(b"/.zarray")}


def test_bf16_run_writes_the_jax_dtypes(runs):
    jax_out, _ = runs("jax", "rdot_nll", "--dtype", "bfloat16")
    port_out, _ = runs("torch", "rdot_nll", "--dtype", "bfloat16")
    for sub in ("checkpoint-2", "final"):
        want = _zarray_dtypes(jax_out / sub)
        assert _zarray_dtypes(port_out / sub) == want and want, sub
        assert _read_json(port_out / sub / "_METADATA") == _read_json(jax_out / sub / "_METADATA")
        restored = ocp.StandardCheckpointer().restore(str(port_out / sub))
        dtypes = {str(np.asarray(x).dtype) for x in jax.tree.leaves(restored)}
        assert "bfloat16" not in dtypes and "float32" in dtypes, (sub, dtypes)


def test_unknown_save_format_raises_before_training(tmp_path):
    from convdr_torch.core.config import TrainConfig as PortTrainConfig
    from convdr_torch.train import checkpoint as tck
    from convdr_torch.train import loop as tloop

    calls = []

    class Dataset:
        def __len__(self):
            calls.append("len")
            return 8

    with pytest.raises(ValueError, match="'npz' is not one of"):
        tloop.train_one_model(Dataset(), None, None, PortTrainConfig(), save_format="npz")
    assert calls == []
    with pytest.raises(ValueError, match="'npz' is not one of"):
        tck.save_state(str(tmp_path / "x"), torch.nn.Linear(2, 2), "npz")
    assert not os.path.exists(tmp_path / "x")
    with pytest.raises(SystemExit):
        torch_train.get_arguments(["--output_dir", "o", "--train_file", "t", "--model_type",
                                   "rdot_nll", "--save_format", "npz"])
