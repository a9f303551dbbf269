"""bf16 and native (.cnb) embedding blocks in the port against the JAX
package (CPU): the files cross-read both ways, ``generate_embeddings``
writes the same bf16 bytes from the same f32 rows (round to nearest even,
NaN and infinities included) and bf16 blocks within bf16 rounding of the
JAX package's on the tiny model, the bf16 search's top-k sets equal the
JAX searcher's on the same files, and both drivers take
``--storage_dtype bfloat16`` and ``--block_format native`` end to end."""

import os
import pickle

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from convdr_torch.core.config import SearchConfig
from convdr_torch.data.token_cache import TokenCache, TokenCacheWriter
from convdr_torch.drivers import gen_passage_embeddings as torch_embed
from convdr_torch.drivers import run_convdr_inference as torch_infer
from convdr_torch.parallel.mesh import shard_rows
from convdr_torch.retrieval import blocks as tblocks
from convdr_torch.retrieval.embed_corpus import generate_embeddings as torch_generate
from convdr_torch.retrieval.searcher import BlockedSearcher
from convdr_tpu.core.config import SearchConfig as JaxSearchConfig
from convdr_tpu.data.token_cache import TokenCache as JaxTokenCache
from convdr_tpu.drivers import gen_passage_embeddings as jax_embed
from convdr_tpu.drivers import run_convdr_inference as jax_infer
from convdr_tpu.retrieval import blocks as jblocks
from convdr_tpu.retrieval.embed_corpus import generate_embeddings as jax_generate
from convdr_tpu.retrieval.searcher import BlockedSearcher as JaxSearcher
from test_torch_pipeline import chain, embed_args, infer_args  # noqa: F401

CPU = torch.device("cpu")
BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": np.float32, "bf16": BF16, "int8": np.int8}


def rows(rng, n, d, dtype):
    x = rng.randn(n, d).astype(np.float32)
    if dtype == np.int8:
        return np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    return x.astype(dtype)


def same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fmt", ["pickle", "native"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_blocks_cross_read_both_ways(tmp_path, dtype, fmt):
    rng = np.random.RandomState(3)
    data = [(rows(rng, n, 16, DTYPES[dtype]), rng.randint(0, 10**6, n)) for n in (33, 0, 7)]
    for writer, reader, name in (
        (tblocks.write_embedding_block, jblocks.iter_embedding_blocks, "torch_wrote"),
        (jblocks.write_embedding_block, tblocks.iter_embedding_blocks, "jax_wrote"),
    ):
        d = str(tmp_path / name)
        for b, (emb, ids) in enumerate(data):
            writer(d, b, emb, ids, emb_prefix="e_", embid_prefix="i_", fmt=fmt)
        kwargs = {"emb_prefix": "e_", "embid_prefix": "i_"}
        got = list(reader(d, **kwargs))
        assert [b for b, _, _ in got] == [0, 1, 2]
        for (_b, emb, ids), (want_emb, want_ids) in zip(got, data):
            same_bits(emb, want_emb)
            np.testing.assert_array_equal(ids, want_ids)
    # one writer, the same bytes
    for name in sorted(os.listdir(tmp_path / "jax_wrote")):
        assert (tmp_path / "jax_wrote" / name).read_bytes() == (
            tmp_path / "torch_wrote" / name).read_bytes(), name


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_mmap_pickle_block_reads_each_rank_slice(tmp_path, dtype):
    """``mmap`` maps a protocol-4 pickle's payload (700 x 48 rows: f32 and
    bf16 past a pickle frame, int8 inside one): the map and each of three
    ranks' row ranges equal the unpickled rows bit for bit. Without the row
    width it raises; a protocol-2 pickle, which has no such payload, is
    read whole."""
    rng = np.random.RandomState(6)
    emb, ids = rows(rng, 700, 48, DTYPES[dtype]), rng.randint(0, 10**6, 700)
    tblocks.write_embedding_block(str(tmp_path), 0, emb, ids)
    got, got_ids = tblocks.load_embedding_block(str(tmp_path), 0, mmap=True, dim=48)
    assert isinstance(got, np.memmap)
    np.testing.assert_array_equal(got_ids, ids)
    same_bits(np.array(got), emb)
    for shard in range(3):
        lo, hi, _ = shard_rows(700, 3, shard, 64)
        same_bits(np.array(got[lo:hi]), emb[lo:hi])
    with pytest.raises(ValueError, match="needs its row width"):
        tblocks.load_embedding_block(str(tmp_path), 0, mmap=True)
    with open(tmp_path / f"{tblocks.EMB_PREFIX}_data_obj_0.pb", "wb") as f:
        pickle.dump(emb, f, protocol=2)
    got, _ = tblocks.load_embedding_block(str(tmp_path), 0, mmap=True, dim=48)
    assert not isinstance(got, np.memmap)
    same_bits(got, emb)


def test_default_prefixes_native_wins_and_bad_rows(tmp_path):
    rng = np.random.RandomState(4)
    emb = rows(rng, 5, 8, BF16)
    d = str(tmp_path)
    tblocks.write_embedding_block(d, 0, emb, np.arange(5))
    assert os.path.exists(os.path.join(d, "passage__emb_p__data_obj_0.pb"))
    # a .cnb file of the same block id is read in place of the pickle pair
    tblocks.write_embedding_block(d, 0, emb[:2], np.arange(2), fmt="native")
    got = tblocks.load_embedding_block(d, 0)
    same_bits(got[0], emb[:2])
    assert tblocks.load_embedding_block(d, 1) is None
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        tblocks.write_embedding_block(d, 2, np.zeros((2, 2), np.float16), np.arange(2))
    with pytest.raises(ValueError, match="block format"):
        tblocks.write_embedding_block(d, 2, emb, np.arange(5), fmt="npy")
    t = tblocks.host_tensor(emb)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), emb.astype(np.float32))


# f32 values whose bf16 rounding is a tie, just off a tie, or special
SPECIAL = np.array(
    [1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-8 + 2**-20, 2**-130, -2**-140,
     np.inf, -np.inf, np.nan, 3.39e38, -3.4e38, 0.0, -0.0, 1.0, 65504.0, 1e-45],
    np.float32,
)


def special_table(rng, n_rows, dim):
    table = rng.randn(n_rows, dim).astype(np.float32)
    flat = table.reshape(-1)
    flat[: SPECIAL.size * 3: 3] = SPECIAL
    flat[1] = np.array([0xFFC00001], np.uint32).view(np.float32)[0]  # -NaN, payload
    return table


def fixed_cache(path, n):
    rng = np.random.RandomState(5)
    with TokenCacheWriter(path, 12) as w:
        for i in range(n):
            ids = rng.randint(3, 200, rng.randint(2, 13))
            ids[1] = i  # row i of the table below
            w.write(ids)


@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_bf16_blocks_byte_identical_from_identical_f32_rows(tmp_path, fmt):
    """Both packages' embed loops, with an "encoder" that returns fixed f32
    rows (ties, NaN, infinities, subnormals among them), write the same
    bf16 bytes."""
    n = 23
    table = special_table(np.random.RandomState(6), n, 8)
    fixed_cache(str(tmp_path / "passages"), n)
    table_t = torch.from_numpy(table)

    def torch_fn(ids, mask, is_query):
        assert not is_query
        return table_t[ids[:, 1]]

    def jax_fn(params, ids, mask, is_query):
        return params[ids[:, 1]]

    kw = dict(batch_size=4, num_blocks=2, length_buckets=(4, 8, 12),
              block_format=fmt, storage_dtype="bfloat16")
    rows_t = torch_generate(torch_fn, TokenCache(str(tmp_path / "passages")),
                            str(tmp_path / "t"), device=CPU, **kw)
    rows_j = jax_generate(jax_fn, jnp.asarray(table), JaxTokenCache(str(tmp_path / "passages")),
                          str(tmp_path / "j"), **kw)
    assert rows_t == rows_j == n
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == (2 if fmt == "native" else 4)
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    got = np.concatenate([e for _b, e, _i in tblocks.iter_embedding_blocks(str(tmp_path / "t"))])
    offs = np.concatenate([i for _b, _e, i in tblocks.iter_embedding_blocks(str(tmp_path / "t"))])
    same_bits(got, table[offs].astype(BF16))


@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_generate_embeddings_bf16_on_tiny_model_matches_jax(chain, tmp_path, fmt):
    from convdr_torch.core.loading import load_model_and_params as torch_load
    from convdr_torch.core.loading import make_apply_fn as torch_apply
    from convdr_tpu.core.loading import load_model_and_params as jax_load
    from convdr_tpu.core.loading import make_apply_fn as jax_apply

    model_dir = str(chain / "model")
    _c, _t, model = torch_load("rdot_nll", model_dir, device=CPU, arch_preset="tiny")
    _c, _t, jmodel, params = jax_load("rdot_nll", model_dir, arch_preset="tiny")
    cache = str(chain / "processed" / "passages")
    kw = dict(batch_size=4, num_blocks=2, block_format=fmt, storage_dtype="bfloat16",
              emb_prefix="p_", embid_prefix="pid_")
    torch_generate(torch_apply(model), TokenCache(cache), str(tmp_path / "t"), device=CPU, **kw)
    jax_generate(jax_apply(jmodel), params, JaxTokenCache(cache), str(tmp_path / "j"), **kw)
    kw_read = {"emb_prefix": "p_", "embid_prefix": "pid_"}
    for (_b, et, it), (_b2, ej, ij) in zip(
        tblocks.iter_embedding_blocks(str(tmp_path / "t"), **kw_read),
        jblocks.iter_embedding_blocks(str(tmp_path / "j"), **kw_read),
    ):
        assert et.dtype == ej.dtype == BF16
        np.testing.assert_array_equal(it, ij)
        # the f32 rows agree within 1e-5; each side rounds its own to bf16,
        # so the stored rows differ by at most one bf16 ulp (2^-7 relative)
        a, b = et.astype(np.float32), ej.astype(np.float32)
        assert np.all(np.abs(a - b) <= 2.0**-7 * np.maximum(np.abs(a), np.abs(b)) + 1e-6)


@pytest.mark.parametrize("storage", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_bf16_block_search_sets_equal_jax(tmp_path, storage, fmt):
    rng = np.random.RandomState(7)
    q = rng.randn(6, 32).astype(np.float32)
    p = rows(rng, 900, 32, BF16)
    p[[5, 700]] = p[300]  # exact ties across blocks
    d = str(tmp_path)
    for b, lo in enumerate((0, 450)):
        tblocks.write_embedding_block(d, b, p[lo:lo + 450], 3 * np.arange(lo, lo + 450), fmt=fmt)
    cfg = dict(storage_dtype=storage, passage_block_size=256)
    s, off = BlockedSearcher(SearchConfig(**cfg), device=CPU).search_blocks(d, q, 40)
    js, joff = JaxSearcher(JaxSearchConfig(**cfg)).search_blocks(d, q, 40)
    for r in range(6):
        assert set(off[r]) == set(joff[r])
    if storage != "int8":
        np.testing.assert_allclose(s, js, rtol=1e-5)
        # the exact f32 scores of the stored rows
        ref = q @ p.astype(np.float32).T
        want = np.sort(ref, axis=1)[:, ::-1][:, :40]
        np.testing.assert_allclose(s, want, rtol=1e-5)


def test_rescore_rejects_bf16_block_files(tmp_path):
    rng = np.random.RandomState(8)
    d = str(tmp_path)
    tblocks.write_embedding_block(d, 0, rows(rng, 50, 8, BF16), np.arange(50))
    searcher = BlockedSearcher(SearchConfig(storage_dtype="bfloat16", rescore_factor=2),
                               device=CPU)
    with pytest.raises(ValueError, match="float block files"):
        searcher.search_blocks(d, np.zeros((2, 8), np.float32), 5)


@pytest.mark.parametrize("fmt", ["pickle", "native"])
def test_bf16_drivers_end_to_end_match_jax(chain, fmt):
    """Both embed drivers with --storage_dtype bfloat16 --block_format fmt
    (bf16 compute), then both inference drivers over the port's blocks with
    --storage_dtype bfloat16: the same top-10 sets; the port's search over
    the JAX package's blocks reads them too."""
    flags = ["--storage_dtype", "bfloat16", "--block_format", fmt]
    t_dir, j_dir = f"t_bf16_{fmt}", f"j_bf16_{fmt}"
    torch_embed.main(embed_args(chain, t_dir) + ["--no_cuda", *flags])
    jax_embed.main(embed_args(chain, j_dir) + ["--no_mesh", *flags])
    suffix = ".cnb" if fmt == "native" else ".pb"
    assert all(n.endswith(suffix) for n in os.listdir(chain / t_dir))
    for (_b, et, it), (_b2, ej, ij) in zip(tblocks.iter_embedding_blocks(str(chain / t_dir)),
                                            jblocks.iter_embedding_blocks(str(chain / j_dir))):
        assert et.dtype == ej.dtype == BF16
        np.testing.assert_array_equal(it, ij)
    search = ["--storage_dtype", "bfloat16"]
    torch_infer.main(infer_args(chain, t_dir, f"t_{fmt}", "--no_cuda", *search))
    jax_infer.main(infer_args(chain, t_dir, f"j_{fmt}", "--no_mesh", *search))
    torch_infer.main(infer_args(chain, j_dir, f"tj_{fmt}", "--no_cuda", *search))

    def sets(name):
        out = {}
        for line in open(chain / f"{name}.trec"):
            qid, _, pid, *_ = line.split()
            out.setdefault(qid, set()).add(pid)
        return out

    assert sets(f"t_{fmt}") == sets(f"j_{fmt}")
    assert set(sets(f"tj_{fmt}")) == set(sets(f"t_{fmt}"))
