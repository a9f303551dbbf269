"""``--matmul_precision high/default`` in the port against the JAX package,
on the CPU.

On the CPU both packages compute every precision in full f32 (XLA:CPU's
``jnp.dot`` gives the same bits at DEFAULT, HIGH and HIGHEST), so the port's
"high" and "default" are held to the JAX package's under the "highest"
contract: the same top-k indices for f32 passages (scores within 1e-5
relative), the same top-k sets for bf16 passages. This covers
``flat_ip_topk``, ``BlockedSearcher`` (``SearchConfig.matmul_precision``),
the sharded search over two gloo ranks, and both drivers (which build
``OnlineSearcher.from_blocks(precision=)`` and ``BlockedSearcher``).

On the card the products round (a TF32 product for "high", bf16 operands
with f32 accumulation for "default"; ``tests/test_torch_cuda.py``). Their
plain emulation, ``rounded_scores_plain``, is held here to numpy: operands
rounded bit for bit as numpy rounds them (``ml_dtypes`` bf16, a TF32
round-to-nearest-away of the f32 bits), products within 1e-5 relative of a
float64 numpy product of the rounded operands, and every score within the
rounding's error bound of the exact one.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.drivers import serve_online as torch_serve
from convdr_torch.ops import exact_search as tes
from convdr_torch.parallel.dryrun import run_cases, spawn
from convdr_torch.retrieval.blocks import write_embedding_block
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.drivers import run_convdr_inference as jax_infer
from convdr_tpu.drivers import serve_online as jax_serve
from convdr_tpu.ops import exact_search as jes
from convdr_tpu.parallel.mesh import get_mesh
from convdr_tpu.parallel.sharded_search import sharded_flat_ip_topk
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxSearcher
from test_torch_online import runs_equal, serve_args
from test_torch_pipeline import chain, embedded, infer_args  # noqa: F401

CPU = torch.device("cpu")
REDUCED = ["high", "default"]
# unit roundoff of each precision's operands: TF32 keeps 11 significant
# bits, bf16 8
UNIT = {"high": 2.0 ** -11, "default": 2.0 ** -8}


TIES = (20, 250, 290)  # equal rows in different blocks and shards


def problem(seed, q=6, n=700, d=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    if n > TIES[-1]:
        x[list(TIES[1:])] = x[TIES[0]]
    qs = rng.standard_normal((q, d), dtype=np.float32)
    qs[0] = x[TIES[0] % n]
    return qs, x


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_ip_topk_matches_jax(precision, storage, seed):
    q, x = problem(seed)
    p = t(x) if storage == "float32" else t(x).to(torch.bfloat16)
    jp = jnp.asarray(x) if storage == "float32" else jnp.asarray(x, jnp.bfloat16)
    kw = dict(block_rows=256, valid_rows=660)
    s, i = tes.flat_ip_topk(t(q), p, 20, precision=precision, **kw)
    js, ji = jes.flat_ip_topk(jnp.asarray(q), jp, 20, precision=precision, **kw)
    hs, hi = tes.flat_ip_topk(t(q), p, 20, **kw)
    np.testing.assert_array_equal(i.numpy(), hi.numpy())  # "highest" on the CPU
    np.testing.assert_array_equal(s.numpy(), hs.numpy())
    if storage == "float32":
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    else:
        for r in range(q.shape[0]):
            assert set(i[r].tolist()) == set(np.asarray(ji)[r].tolist()), r
    assert (i.numpy()[0, :3] == TIES).all()


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_blocked_searcher_matches_jax(tmp_path, precision, storage):
    """``SearchConfig.matmul_precision`` through ``search_blocks`` over
    three blocks: the same offsets as the JAX searcher's at that precision
    (int8 storage ignores it in both)."""
    q, x = problem(2, n=600)
    for b in range(3):
        rows = np.arange(b, 600, 3)
        write_embedding_block(str(tmp_path), b, x[rows], rows.astype(np.int64) * 7)
    ours = BlockedSearcher(SearchConfig(passage_block_size=64, storage_dtype=storage,
                                        matmul_precision=precision), device=CPU)
    theirs = JaxSearcher(JaxSearchConfig(passage_block_size=64, storage_dtype=storage,
                                         matmul_precision=precision))
    s, off = ours.search_blocks(str(tmp_path), q, 25)
    js, joff = theirs.search_blocks(str(tmp_path), q, 25)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    exact = BlockedSearcher(SearchConfig(passage_block_size=64, storage_dtype=storage),
                            device=CPU).search_blocks(str(tmp_path), q, 25)
    np.testing.assert_array_equal(off, exact[1])


SHARD_ROWS, SHARD_VALID = 384, 300


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The sharded flat search at each reduced precision over two gloo
    ranks (one spawn), rank 0's results."""
    q, x = problem(3, n=SHARD_ROWS)
    flat = dict(queries=q, passages=x, k=10, valid_rows=SHARD_VALID, block_rows=64)
    cases = {f"{p}_{s}": ("flat", dict(flat, precision=p, storage=s))
             for p in REDUCED for s in ("float32", "bfloat16")}
    out = str(tmp_path_factory.mktemp("precision_ranks") / "out.npz")
    spawn(2, run_cases, (cases, out))
    with np.load(out) as f:
        return q, x, dict(f)


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_sharded_search_over_gloo_ranks_matches_jax(two_ranks, precision, storage):
    q, x, got = two_ranks
    mesh = get_mesh(("index",), devices=jax.devices()[:2])
    jx = jnp.asarray(x) if storage == "float32" else jnp.asarray(x, jnp.bfloat16)
    js, ji = sharded_flat_ip_topk(mesh, jnp.asarray(q), jx, 10, valid_rows=SHARD_VALID,
                                  block_rows=64, precision=precision)
    ids = got[f"{precision}_{storage}.ids"]
    if storage == "float32":
        np.testing.assert_array_equal(ids, np.asarray(ji))
        np.testing.assert_allclose(got[f"{precision}_{storage}.scores"], np.asarray(js),
                                   rtol=1e-5)
    else:
        for r in range(q.shape[0]):
            assert set(ids[r].tolist()) == set(np.asarray(ji)[r].tolist()), r
    assert (ids < SHARD_VALID).all()


@pytest.mark.parametrize("precision", REDUCED)
def test_inference_driver_matches_jax(embedded, precision):  # noqa: F811
    """``run_convdr_inference --matmul_precision``: the port's TREC run
    byte-identical to the JAX driver's and to its own "highest" run."""
    flags = ["--matmul_precision", precision]
    jax_infer.main(infer_args(embedded, "torch_emb", f"jp_{precision}", "--no_mesh", *flags))
    torch_infer.main(infer_args(embedded, "torch_emb", f"tp_{precision}", "--no_cuda", *flags))
    torch_infer.main(infer_args(embedded, "torch_emb", "tp_highest", "--no_cuda"))
    ours = (embedded / f"tp_{precision}.trec").read_bytes()
    assert ours == (embedded / f"jp_{precision}.trec").read_bytes()
    assert ours == (embedded / "tp_highest.trec").read_bytes()


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_serve_driver_matches_jax(embedded, precision, storage):  # noqa: F811
    """``serve_online --matmul_precision`` (``OnlineSearcher.from_blocks(
    precision=)``) over flat f32 / bf16 rows: rank for rank the JAX serve
    run at that precision."""
    flags = ["--ann_data_dir", str(embedded / "torch_emb"), "--storage_dtype", storage,
             "--matmul_precision", precision]
    name = f"{precision}_{storage}"
    torch_serve.main(serve_args(embedded, f"sp_t_{name}", flags + ["--no_cuda"]))
    jax_serve.main(serve_args(embedded, f"sp_j_{name}", flags))
    runs_equal(embedded / f"sp_t_{name}.trec", embedded / f"sp_j_{name}.trec")


def tf32_numpy(x):
    """f32 -> TF32 (10 stored mantissa bits), round to nearest, ties away
    from zero, on the bit pattern."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def test_round_to_tf32_matches_numpy():
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.standard_normal(4096, dtype=np.float32) * 10.0 ** rng.integers(-30, 30, 4096),
        np.array([0.0, -0.0, 1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                  np.float32(3.4e38), 1e-40, np.inf, -np.inf], np.float32),
    ]).astype(np.float32)
    got = tes.round_to_tf32(t(x)).numpy()
    want = tf32_numpy(x)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert not (got.view(np.uint32) & 0x1FFF).any()
    assert got[4099] == 1 + 2 ** -10  # a tie rounds away from zero
    finite = np.isfinite(x) & (np.abs(x) > 1e-37) & np.isfinite(got)
    assert (np.abs(got[finite] - x[finite]) <= UNIT["high"] * np.abs(x[finite])).all()


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("d", [8, 96, 768])
def test_card_rounding_plain_emulation_matches_numpy(precision, d):
    """``rounded_scores_plain``: the operands rounded as numpy rounds them,
    the product within 1e-5 relative (of |q| |p|) of numpy's float64
    product of those operands, every score within the rounding's bound
    (2u + u^2 of sum |q_i p_i|, plus f32 accumulation) of the exact f32
    score, and not all scores equal to it."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((5, d), dtype=np.float32)
    p = rng.standard_normal((300, d), dtype=np.float32)
    got = tes.rounded_scores_plain(t(q), t(p), precision).numpy()
    if precision == "high":
        qr, pr = tf32_numpy(q), tf32_numpy(p)
    else:
        qr = q.astype(ml_dtypes.bfloat16).astype(np.float32)
        pr = p.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = qr.astype(np.float64) @ pr.astype(np.float64).T
    norms = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(p, axis=1)[None, :]
    assert (np.abs(got - want) <= 1e-5 * norms).all()
    exact = q.astype(np.float64) @ p.astype(np.float64).T
    u = UNIT[precision]
    bound = (2 * u + u * u + d * 2.0 ** -24) * (np.abs(q) @ np.abs(p).T)
    assert (np.abs(got - exact) <= bound).all()
    assert (got != (q @ p.T)).any()


def test_rounded_scores_takes_only_the_reduced_precisions():
    q, x = problem(5, n=8, d=4)
    for fn in (tes.rounded_scores, tes.rounded_scores_plain):
        with pytest.raises(ValueError, match="precision|takes"):
            fn(t(q), t(x), "highest")
