"""The port's orbax checkpoint reader and writer against the JAX package,
orbax and tensorstore, on the CPU.

* OCDBT: the reader's keys and values equal tensorstore's listing on the
  committed JAX fixture and on a database with interior nodes; the writer's
  databases are read by tensorstore.
* Models: JAX-written tiny ``rdot_nll`` and ``dpr`` ``final/`` dirs (and
  bare dirs) load bitwise as ``flax_params_to_state_dict`` of the JAX
  package's ``restore_checkpoint``, with embeddings within the parity tests'
  1e-5.
* Resume: a JAX ``checkpoint-N`` with accumulation 1 and 2 maps its
  optimizer state bitwise, and the port's next step stays within 5e-6 of the
  JAX package's next step (``tests/test_torch_train.py``'s bound).
* The other way: dirs the port writes are read bitwise by the JAX
  package's ``restore_checkpoint`` and ``load_model_and_params``.
* A bf16 array and a multi-chunk array (with a missing chunk) round-trip.
* The committed fixture ``tests/fixtures_torch/jax_orbax_tiny`` (a JAX
  TrainState of the tiny ``rdot_nll`` model with accumulation 2) decodes to
  its recorded digests, and so does the same state written again by the JAX
  package (OCDBT file names are random, so files are not compared).
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch

from convdr_torch.core.loading import load_model_and_params
from convdr_torch.data.tokenizers import ByteLevelBPETokenizer as TorchBPE
from convdr_torch.models.from_jax import (
    flax_params_to_state_dict,
    opt_state_from_jax,
    state_dict_to_flax,
)
from convdr_torch.train import checkpoint as tck
from convdr_torch.train import trainer as ttr
from convdr_torch.utils import ocdbt, zarr2
from convdr_tpu.core.config import TrainConfig
from convdr_tpu.core.loading import load_model_and_params as jax_load
from convdr_tpu.train import trainer as jtr
from convdr_tpu.train.checkpoint import restore_checkpoint as jax_restore
from convdr_tpu.train.checkpoint import save_checkpoint as jax_save
from test_torch_train import (
    _batches,
    _jax_apply,
    _jax_step1_grads,
    _pair,
    _tiny_model_config,
    port_config,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                       "jax_orbax_tiny")
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _orbax_shape(tree):
    """A live optax state in the shape orbax restores it: namedtuples as
    dicts, tuples as lists, empty states as None."""
    if hasattr(tree, "_asdict"):
        return {k: _orbax_shape(v) for k, v in tree._asdict().items()} or None
    if isinstance(tree, (tuple, list)):
        return [_orbax_shape(v) for v in tree] or None
    if isinstance(tree, dict):
        return {k: _orbax_shape(v) for k, v in tree.items()}
    return tree


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jax_digests(state) -> dict:
    """{orbax array name: sha256, shape, dtype} of a JAX tree's arrays."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        arr = np.array(leaf, order="C", copy=True)  # ascontiguousarray makes 0-d 1-d
        out[".".join(_key_name(k) for k in path)] = {
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "shape": list(arr.shape), "dtype": str(arr.dtype)}
    return out


def port_digests(tree) -> dict:
    out = {}
    for keys, leaf in tck.orbax_leaves(tree):
        if leaf is None:
            continue
        t = leaf.contiguous()
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out[".".join(k for _, k in keys)] = {
            "sha256": hashlib.sha256(words.numpy().tobytes()).hexdigest(),
            "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}
    return out


def fixture_train_state():
    """The fixture: the tiny rdot_nll model's TrainState with accumulation 2
    and masked weight decay, every value from a numpy seed: normal params
    (Huffman literals), moments on a coarse grid (FSE sequences), repeating
    accumulators (long matches) and one zero tree; counts 3, mini step 1,
    7 micro-steps."""
    _cfg, _tok, _model, params = jax_load("rdot_nll", "init", arch_preset="tiny")
    config = TrainConfig(gradient_accumulation_steps=2, weight_decay=0.01)
    state, _ = jtr.create_train_state(params, config, 10)
    rng = np.random.RandomState(15)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if np.issubdtype(np.asarray(leaf).dtype, np.integer):
            return np.int32(1 if "mini_step" in name else 3)
        if ".mu" in name:
            return (np.round(rng.randn(*shape) * 8) / 4096).astype(np.float32)
        if ".nu" in name:
            return (rng.randint(0, 16, size=shape) / 2.0 ** 20).astype(np.float32)
        if "acc_grads" in name:
            return np.resize(np.arange(7, dtype=np.float32) * 1e-3, shape)
        return np.zeros(shape, np.float32)

    params = jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.02).astype(np.float32), params)
    opt = jax.tree_util.tree_map_with_path(fill, state.opt_state)
    return type(state)(params=params, opt_state=opt, step=np.int32(7))


def write_fixture(path: str) -> dict:
    """Write the fixture with the JAX package's ``save_checkpoint``; returns
    its digests (``digests.json`` beside it holds the committed ones)."""
    state = fixture_train_state()
    jax_save(path, state, metadata={"global_step": 3})
    return jax_digests(state)


# ---------------- the committed fixture ----------------
def test_committed_fixture_decodes_to_its_digests():
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        want = json.load(f)
    assert port_digests(tck.read_orbax_tree(FIXTURE)) == want
    assert len(want) > 100


def test_fixture_rewritten_by_jax_decodes_to_the_committed_digests(tmp_path):
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        want = json.load(f)
    assert write_fixture(str(tmp_path / "fx")) == want
    assert port_digests(tck.read_orbax_tree(str(tmp_path / "fx"))) == want


def test_fixture_resumes_into_a_port_train_state():
    _, _, model = load_model_and_params("rdot_nll", None, device=CPU, arch_preset="tiny")
    config = port_config(TrainConfig(gradient_accumulation_steps=2, weight_decay=0.01))
    state, _ = ttr.create_train_state(model, config, 10)
    state = tck.restore_checkpoint(FIXTURE, state)
    assert state.step == 7 and state.opt_state["count"] == 3 and state.opt_state["mini_step"] == 1
    assert set(state.opt_state["acc"]) == set(dict(model.named_parameters()))


# ---------------- OCDBT against tensorstore ----------------
def _tensorstore_db(path, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}",
                            "config": config}).result()


def _interior_db(path):
    kv = _tensorstore_db(path, max_decoded_node_bytes=300, max_inline_value_bytes=16,
                         compression={"id": "zstd", "level": 5})
    rng = np.random.RandomState(3)
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn).write(f"key/{i:03d}/{'x' * (i % 7)}",
                                           rng.bytes(int(rng.randint(1, 40)))).result()
    return str(path)


@pytest.mark.parametrize("which", ["jax_fixture", "interior_nodes"])
def test_ocdbt_reader_equals_tensorstore(tmp_path, which):
    path = FIXTURE if which == "jax_fixture" else _interior_db(tmp_path / "db")
    kv = _tensorstore_db(path)
    want = sorted(k.decode() for k in kv.list().result())
    reader = ocdbt.OcdbtReader(path)
    assert reader.keys() == want and len(want) > 50
    for key in want:
        assert bytes(reader.read(key)) == kv.read(key).result().value, key
    reader.close()


@pytest.mark.parametrize("node_target_bytes", [1 << 20, 200])
def test_ocdbt_writer_read_by_tensorstore(tmp_path, node_target_bytes):
    rng = np.random.RandomState(4)
    items = {f"a.b{i:03d}/{'.zarray' if i % 2 else '0.0'}":
             rng.bytes(int(rng.choice([3, 500, 1500, 5000]))) for i in range(200)}
    ocdbt.write_ocdbt(str(tmp_path / "db"), list(items.items()),
                      node_target_bytes=node_target_bytes)
    kv = _tensorstore_db(tmp_path / "db")
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    for key, value in items.items():
        assert kv.read(key).result().value == value
    reader = ocdbt.OcdbtReader(str(tmp_path / "db"))
    assert all(bytes(reader.read(k)) == v for k, v in items.items())


def test_ocdbt_checksum_and_magic_faults_raise(tmp_path):
    ocdbt.write_ocdbt(str(tmp_path / "db"), [("k", b"v")])
    manifest = tmp_path / "db" / ocdbt.MANIFEST_FILE
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtReader(str(tmp_path / "db"))
    raw[20] ^= 1
    raw[0] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="magic"):
        ocdbt.OcdbtReader(str(tmp_path / "db"))


# ---------------- models ----------------
def _jax_final(tmp_path, model_type, nested):
    cfg, tok, jmodel, params = jax_load(model_type, "init", arch_preset="tiny", seed=3)
    where = tmp_path / "final" if nested else tmp_path
    jax_save(str(where), params, metadata={"model_type": model_type, "global_step": 4})
    tok.save_pretrained(str(tmp_path))
    return jmodel, params


@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
@pytest.mark.parametrize("nested", [True, False])
def test_jax_final_dir_loads_bitwise(tmp_path, model_type, nested):
    jmodel, params = _jax_final(tmp_path, model_type, nested)
    config, tok, model = load_model_and_params(model_type, str(tmp_path), device=CPU,
                                               arch_preset="tiny")
    where = str(tmp_path / "final") if nested else str(tmp_path)
    want = flax_params_to_state_dict(_np(jax_restore(where, params)), config)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    rng = np.random.RandomState(0)
    ids = rng.randint(5, len(tok), size=(3, 17)).astype(np.int32)
    mask = (np.arange(17)[None] < np.array([[17], [9], [4]])).astype(np.int32)
    for method in ("query_emb", "body_emb"):
        ref = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                      method=getattr(jmodel, method)))
        with torch.no_grad():
            ours = getattr(model, method)(torch.from_numpy(ids), torch.from_numpy(mask))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("model_type", ["rdot_nll", "dpr"])
def test_port_written_final_read_by_jax(tmp_path, model_type):
    _, tok, model = load_model_and_params(model_type, None, device=CPU, arch_preset="tiny",
                                          seed=5)
    tck.save_orbax_checkpoint(str(tmp_path / "final"), tck.orbax_tree_of(model),
                              metadata={"model_type": model_type, "global_step": 1})
    tok.save_pretrained(str(tmp_path))
    _cfg, _tok, _jmodel, jparams = jax_load(model_type, str(tmp_path), arch_preset="tiny")
    template = jax_load(model_type, "init", arch_preset="tiny")[3]
    restored = jax_restore(str(tmp_path / "final"), template)
    for tree in (jparams, restored):
        back = flax_params_to_state_dict(_np(tree), model.config)
        for key, value in model.state_dict().items():
            assert torch.equal(back[key], value), key


def test_tree_that_does_not_fit_names_the_key(tmp_path):
    _, _, model = load_model_and_params("rdot_nll", None, device=CPU, arch_preset="tiny")
    params = state_dict_to_flax(model.state_dict(), model.config)
    params["params"]["head_norm"]["bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="head_norm/bias.*shape \\(5,\\)"):
        tck.load_orbax_params(model, params, "here")
    del params["params"]["backbone"]["layer_1"]
    with pytest.raises(ValueError, match="missing key 'params/backbone/layer_1"):
        tck.load_orbax_params(model, params, "here")


# ---------------- resume ----------------
@pytest.mark.parametrize("accum", [1, 2])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, accum):
    cfg = _tiny_model_config()
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2,
                         gradient_accumulation_steps=accum, weight_decay=0.01)
    n = 2 if accum == 1 else 3  # with accumulation: mid-way through a step
    batches = _batches(9, n + 1)
    jmodel, jparams, student = _pair(cfg, 0)
    _, jteacher, teacher = _pair(cfg, 1)
    state, tx = jtr.create_train_state(jparams, config, total_steps=10)
    jstep = jtr.make_train_step(_jax_apply(jmodel), _jax_apply(jmodel), tx, config)
    for batch in batches[:n]:
        state, _ = jstep(state, jteacher, {k: jnp.asarray(v) for k, v in batch.items()})
    ckpt = str(tmp_path / f"checkpoint-{n // accum}")
    jax_save(ckpt, state, metadata={"global_step": n // accum})
    saved = _np(state)
    state, jm = jstep(state, jteacher, {k: jnp.asarray(v) for k, v in batches[n].items()})

    pconfig = port_config(config)
    tstate, ttx = ttr.create_train_state(student, pconfig, 10)
    tstate = tck.restore_checkpoint(ckpt, tstate)
    want = opt_state_from_jax(_orbax_shape(saved.opt_state), student.config)
    assert tstate.step == n == int(saved.step)
    assert {k: v for k, v in tstate.opt_state.items() if not isinstance(v, dict)} == \
        {k: v for k, v in want.items() if not isinstance(v, dict)}
    for group in ("mu", "nu") + (("acc",) if accum > 1 else ()):
        for name, value in want[group].items():
            assert torch.equal(tstate.opt_state[group][name], value), (group, name)
    for name, value in flax_params_to_state_dict(saved.params, student.config).items():
        assert torch.equal(student.state_dict()[name], value), name

    # the resumed step: its metrics to the parity tests' rtol 1e-4, its
    # gradients and new moments to their 5e-6 (the parameters themselves
    # are not compared: Adam scales the key bias's gradient, zero but for
    # rounding, to a full step)
    tstep = ttr.make_train_step(student, teacher, ttx, pconfig)
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batches[n].items()})
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    jgrads = flax_params_to_state_dict(_np(_jax_step1_grads(
        jmodel, saved.params, jteacher, {k: jnp.asarray(v) for k, v in batches[n].items()},
        config)), student.config)
    after = opt_state_from_jax(_orbax_shape(_np(state.opt_state)), student.config)
    for name, p in student.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), atol=5e-6, rtol=0,
                                   err_msg=name)
        for group in ("mu", "nu"):
            np.testing.assert_allclose(tstate.opt_state[group][name].numpy(),
                                       after[group][name].numpy(), atol=5e-6, rtol=0,
                                       err_msg=f"{group} {name}")
    assert tstate.opt_state["count"] == after["count"]


@pytest.mark.parametrize("accum", [1, 2])
def test_port_train_state_read_by_jax(tmp_path, accum):
    cfg = _tiny_model_config()
    config = TrainConfig(learning_rate=1e-3, ranking_task=True, num_negatives=2,
                         gradient_accumulation_steps=accum, weight_decay=0.01 * (accum - 1))
    _jmodel, jparams, student = _pair(cfg, 0)
    _, _, teacher = _pair(cfg, 1)
    pconfig = port_config(config)
    tstate, ttx = ttr.create_train_state(student, pconfig, 10)
    tstep = ttr.make_train_step(student, teacher, ttx, pconfig)
    for batch in _batches(4, 3):
        tstate, _ = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    path = str(tmp_path / "checkpoint-1")
    tck.save_orbax_checkpoint(path, tck.orbax_tree_of(tstate, config.weight_decay),
                              metadata={"global_step": 3 // accum})
    template, _ = jtr.create_train_state(jparams, config, 10)
    back = _np(jax_restore(path, template))
    assert int(back.step) == 3
    mapped = opt_state_from_jax(_orbax_shape(back.opt_state), student.config)
    for key, value in tstate.opt_state.items():
        if isinstance(value, dict):
            for name, t in value.items():
                assert torch.equal(mapped[key][name], t), (key, name)
        else:
            assert mapped[key] == value, key
    for name, value in flax_params_to_state_dict(back.params, student.config).items():
        assert torch.equal(student.state_dict()[name], value), name
    # and the port reads its own orbax dir back into a fresh state
    _, _, other = _pair(cfg, 2)
    fresh, _ = ttr.create_train_state(other, pconfig, 10)
    fresh = tck.restore_checkpoint(path, fresh)
    for name, value in student.state_dict().items():
        assert torch.equal(other.state_dict()[name], value), name


# ---------------- dtypes and chunk grids ----------------
def test_bf16_and_scalar_arrays_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    tree = {"a": torch.from_numpy(rng.randn(5, 3).astype(np.float32)).to(torch.bfloat16),
            "b": [torch.from_numpy(rng.randn(4).astype(np.float32)), None, ()],
            "c": torch.tensor(11, dtype=torch.int32),
            "d": torch.from_numpy(rng.rand(6) > 0.5)}
    path = str(tmp_path / "ck")
    tck.save_orbax_checkpoint(path, tree)
    back = tck.read_orbax_tree(path)
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0], tree["b"][0]) and back["b"][1] is None
    assert back["b"][2] is None  # orbax skips an empty tuple
    assert torch.equal(back["c"], tree["c"]) and torch.equal(back["d"], tree["d"])
    template = {"a": np.zeros((5, 3), ml_dtypes.bfloat16),
                "b": [np.zeros(4, np.float32), None, ()],
                "c": np.int32(0), "d": np.zeros(6, bool)}
    jax_back = jax_restore(path, template)
    assert np.array_equal(np.asarray(jax_back["a"]).view(np.int16),
                          tree["a"].view(torch.int16).numpy())
    assert int(jax_back["c"]) == 11


def test_multi_chunk_array_with_a_missing_chunk(tmp_path):
    base = {"driver": "ocdbt", "base": f"file://{tmp_path / 'db'}"}
    arr = ts.open({"driver": "zarr", "kvstore": base, "path": "grid.w",
                   "metadata": {"shape": [20, 13], "chunks": [7, 5], "dtype": "<f4",
                                "compressor": {"id": "zstd", "level": 3},
                                "fill_value": 1.5}},
                  create=True).result()
    values = np.random.RandomState(6).randn(20, 13).astype(np.float32)
    values[7:14, 5:10] = 1.5  # chunk (1, 1): equal to the fill, so not stored
    arr[...] = values
    reader = ocdbt.OcdbtReader(str(tmp_path / "db"))
    assert "grid.w/0.0" in reader and "grid.w/2.2" in reader
    assert "grid.w/1.1" not in reader
    got = zarr2.read_array(reader, "grid.w")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), values)


def test_zarr_and_orbax_metadata_faults_raise(tmp_path):
    meta = {"chunks": [2], "compressor": None, "dtype": "<f4", "fill_value": None,
            "filters": None, "order": "C", "shape": [2], "zarr_format": 2}
    zarr2.parse_zarray(json.dumps(meta).encode())
    for bad, match in (({"order": "F"}, "order"), ({"filters": [{"id": "delta"}]}, "filters"),
                       ({"compressor": {"id": "blosc"}}, "compressor"),
                       ({"dtype": ">f4"}, "dtype")):
        with pytest.raises(ValueError, match=match):
            zarr2.parse_zarray(json.dumps({**meta, **bad}).encode())
    tck.save_orbax_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros(3)})
    with open(tmp_path / "ck" / "_METADATA") as f:
        orbax_meta = json.load(f)
    for change, match in (({"use_zarr3": True}, "zarr3"), ({"use_ocdbt": False}, "OCDBT")):
        with open(tmp_path / "ck" / "_METADATA", "w") as f:
            json.dump({**orbax_meta, **change}, f)
        with pytest.raises(ValueError, match=match):
            tck.read_orbax_tree(str(tmp_path / "ck"))
    entry = next(iter(orbax_meta["tree_metadata"].values()))
    entry["key_metadata"][0]["key_type"] = 3
    with open(tmp_path / "ck" / "_METADATA", "w") as f:
        json.dump(orbax_meta, f)
    with pytest.raises(ValueError, match="key type 3"):
        tck.read_orbax_tree(str(tmp_path / "ck"))


# ---------------- a JAX training run resumed by the port's loop ----------------
@pytest.mark.parametrize("accum", [1, 2])
def test_port_loop_resumes_a_jax_run(tmp_path, accum):
    """The JAX loop trains 2 epochs, saving ``checkpoint-2`` on the way; the
    port's ``train_one_model(resume=True)`` over a dir holding only that
    checkpoint continues to the same global step, each logged loss within
    the loop parity test's rtol 1e-4 of the JAX run's."""
    import shutil

    from convdr_tpu.data.conv_dataset import ConvSearchDataset as JaxDataset
    from convdr_tpu.data.tokenizers import ByteLevelBPETokenizer as JaxBPE
    from convdr_tpu.train import loop as jloop
    from convdr_torch.core import config as tcfg
    from convdr_torch.train import loop as tloop
    from test_torch_train_loop import CONFIG, _models, _torch_dataset, write_topics
    from test_torch_train_loop import _jax_apply as loop_apply

    class Recorder:
        def __init__(self):
            self.rows = []

        def log(self, step, means):
            self.rows.append((step, means["loss"]))

        def close(self):
            pass

    topics = write_topics(tmp_path / "train.jsonl", 8)
    config = TrainConfig(num_train_epochs=2.0, save_steps=2, gradient_accumulation_steps=accum,
                         weight_decay=0.01, **CONFIG)
    jmodel, jparams, student = _models(0)
    _, jteacher, teacher = _models(1)
    jds = JaxDataset([topics], JaxBPE.tiny(), mode="train", ranking_task=True,
                     max_concat_length=40, max_query_length=16)
    jrec = Recorder()
    _, j_step, _ = jloop.train_one_model(
        jds, loop_apply(jmodel), jparams, loop_apply(jmodel), jteacher, config,
        tokenizer=JaxBPE.tiny(), output_dir=str(tmp_path / "jax"), metrics=jrec)
    shutil.copytree(tmp_path / "jax" / "checkpoint-2", tmp_path / "port" / "checkpoint-2")
    trec = Recorder()
    _, t_step, _ = tloop.train_one_model(
        _torch_dataset(topics), student, teacher, tcfg.TrainConfig(**config.__dict__),
        tokenizer=TorchBPE.tiny(), output_dir=str(tmp_path / "port"), metrics=trec,
        resume=True)
    assert t_step == j_step == 8 // accum
    want = [(s, v) for s, v in jrec.rows if s > 2]
    assert [s for s, _ in trec.rows] == [s for s, _ in want] and want
    np.testing.assert_allclose([v for _, v in trec.rows], [v for _, v in want], rtol=1e-4)
