"""The port's sharded searches over S gloo ranks against the JAX package's
over S of the conftest's 8 virtual CPU devices, at S = 2 and 8, and for
IVF also at S = 3, whose padded sub-list count is uneven.

One spawn a world size (module scope) runs every case on S ranks and
writes rank 0's results to an npz; each check reads it. The corpus is
padded to 384 rows (every S divides it) with 300 valid rows, so the last
shards hold pad rows and at S = 8 one shard has none valid; rows 10, 200
and 290 are equal, so ties cross shards. Contracts: flat f32 and int8
indices equal to JAX's and to the unsharded port's, f32 scores within 1e-6
relative, int8 scores equal, bf16 top-k sets equal; sharded PQ (packed and
not) equal to JAX's; sharded IVF (f32, int8, packed IVFPQ; nprobe 3, which
allocates ceil(3 / S) probes a shard) equal to JAX's sharded IVF at the
same S, and at full probe its sets equal to the flat search's (f32) or the
single-device full probe's (int8, IVFPQ).
"""

import numpy as np
import pytest
import torch

from convdr_torch.ops.exact_search import flat_ip_topk
from convdr_torch.ops.pq import PQCodec, pack_codes_4bit
from convdr_torch.ops.quant import Int8Quantizer
from convdr_torch.parallel.dryrun import run_cases, spawn
from convdr_torch.retrieval.ivf import IVFIndex
from convdr_tpu.parallel.mesh import get_mesh
from convdr_tpu.parallel.sharded_search import sharded_flat_ip_topk, sharded_pq_topk
from convdr_tpu.retrieval import ivf as jivf

import jax
import jax.numpy as jnp

N_PAD, VALID, D, Q, K, BLOCK = 384, 300, 16, 6, 10, 32
FLAT_WORLDS = [2, 8]
IVF_WORLDS = [2, 3, 8]
IVF_KINDS = ("float32", "int8", "pq4")


def _inputs():
    rng = np.random.Generator(np.random.PCG64(7))
    x = rng.standard_normal((N_PAD, D), dtype=np.float32)
    x[200] = x[290] = x[10]  # equal rows on three shards at S = 2, 3, 8
    q = rng.standard_normal((Q, D), dtype=np.float32)
    q[0] = x[10]
    quant = Int8Quantizer.fit(x[:VALID])
    codec = PQCodec.fit(x[:VALID], m=4, nbits=4, iters=4, seed=0, device="cpu")
    codes = codec.encode(x, device="cpu")
    return {"x": x, "q": q, "x8": quant.quantize_passages(x), "q8": quant.quantize_queries(q)[0],
            "lut": codec.lut(q), "codes": codes, "packed": pack_codes_4bit(codes), "ksub": 16}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = _inputs()
    for kind in IVF_KINDS:
        path = str(tmp_path_factory.mktemp(f"ivf_{kind}"))
        IVFIndex.build(d["x"][:VALID], 8, storage_dtype=kind, pq_m=4, pack=kind == "pq4",
                       iters=4, seed=0, device="cpu").save(path)
        d[f"ivf_{kind}"] = path
    return d


def _cases(d):
    flat = dict(k=K, valid_rows=VALID, block_rows=BLOCK)
    cases = {
        "f32": ("flat", dict(queries=d["q"], passages=d["x"], **flat)),
        "int8": ("flat", dict(queries=d["q8"], passages=d["x8"], **flat)),
        "bf16": ("flat", dict(queries=d["q"], passages=d["x"], storage="bfloat16", **flat)),
        "pq": ("pq", dict(lut=d["lut"], codes=d["codes"], k=K, ksub=16, valid_rows=VALID,
                          block_rows=BLOCK)),
        "pq_packed": ("pq", dict(lut=d["lut"], codes=d["packed"], k=K, ksub=16, packed=True,
                                 valid_rows=VALID, block_rows=BLOCK)),
    }
    for kind in IVF_KINDS:
        for nprobe in (3, 999):
            cases[f"ivf_{kind}_{nprobe}"] = ("ivf_index", dict(
                index_dir=d[f"ivf_{kind}"], queries=d["q"], k=K, nprobe=nprobe))
    return cases


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """S -> (S, the port's results over S ranks, the JAX mesh of S
    devices); one spawn a world size, on first use."""
    runs = {}

    def world(s):
        if s not in runs:
            out = str(tmp_path_factory.mktemp(f"ranks{s}") / "out.npz")
            spawn(s, run_cases, (_cases(data), out))
            with np.load(out) as f:
                runs[s] = (s, dict(f), get_mesh(("index",), devices=jax.devices()[:s]))
        return runs[s]

    return world


def _unsharded(q, x):
    s, i = flat_ip_topk(torch.from_numpy(q), torch.from_numpy(x), K, valid_rows=VALID,
                        block_rows=BLOCK)
    return s.numpy(), i.numpy()


def _jax_flat(mesh, q, x):
    s, i = sharded_flat_ip_topk(mesh, jnp.asarray(q), x, K, valid_rows=VALID, block_rows=BLOCK)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n", FLAT_WORLDS)
def test_flat_f32_equals_jax_and_unsharded(worlds, n, data):
    _s, got, mesh = worlds(n)
    want_s, want_i = _jax_flat(mesh, data["q"], jnp.asarray(data["x"]))
    np.testing.assert_array_equal(got["f32.ids"], want_i)
    np.testing.assert_array_equal(got["f32.ids"], _unsharded(data["q"], data["x"])[1])
    np.testing.assert_allclose(got["f32.scores"], want_s, rtol=1e-6, atol=0)
    assert (got["f32.ids"] < VALID).all() and (got["f32.ids"][0, :3] == [10, 200, 290]).all()


@pytest.mark.parametrize("n", FLAT_WORLDS)
def test_flat_int8_equals_jax_and_unsharded(worlds, n, data):
    _s, got, mesh = worlds(n)
    want_s, want_i = _jax_flat(mesh, data["q8"], jnp.asarray(data["x8"]))
    np.testing.assert_array_equal(got["int8.ids"], want_i)
    np.testing.assert_array_equal(got["int8.scores"], want_s)
    np.testing.assert_array_equal(got["int8.ids"], _unsharded(data["q8"], data["x8"])[1])


@pytest.mark.parametrize("n", FLAT_WORLDS)
def test_flat_bf16_sets_equal_jax(worlds, n, data):
    _s, got, mesh = worlds(n)
    _want_s, want_i = _jax_flat(mesh, data["q"], jnp.asarray(data["x"], jnp.bfloat16))
    for r in range(Q):
        assert set(got["bf16.ids"][r]) == set(want_i[r].tolist()), r


@pytest.mark.parametrize("n", FLAT_WORLDS)
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_pq_equals_jax(worlds, n, data, packed):
    _s, got, mesh = worlds(n)
    name = "pq_packed" if packed else "pq"
    want_s, want_i = sharded_pq_topk(
        mesh, jnp.asarray(data["lut"]), jnp.asarray(data["packed" if packed else "codes"]), K,
        16, valid_rows=VALID, block_rows=BLOCK, packed=packed)
    np.testing.assert_array_equal(got[f"{name}.ids"], np.asarray(want_i))
    np.testing.assert_allclose(got[f"{name}.scores"], np.asarray(want_s), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", IVF_WORLDS)
@pytest.mark.parametrize("kind", IVF_KINDS)
def test_ivf_equals_jax_sharded_and_full_probe_equals_flat(worlds, n, data, kind):
    s, got, mesh = worlds(n)
    index = jivf.IVFIndex.load(data[f"ivf_{kind}"])
    want_s, want_i = index.search(data["q"], K, nprobe=3, mesh=mesh)
    np.testing.assert_array_equal(got[f"ivf_{kind}_3.ids"], want_i)
    np.testing.assert_allclose(got[f"ivf_{kind}_3.scores"], want_s, rtol=1e-6, atol=1e-6)
    full = got[f"ivf_{kind}_999.ids"]
    if kind == "float32":
        exact = _unsharded(data["q"], data["x"])[1]
    else:  # the exhaustive search of the same codes: the single-device full probe
        exact = IVFIndex.load(data[f"ivf_{kind}"], device="cpu").search(
            data["q"], K, nprobe=999)[1]
    for r in range(Q):
        assert set(full[r]) == set(exact[r]), (s, r)
