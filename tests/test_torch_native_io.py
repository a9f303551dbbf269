"""The port's C++ host library (convdr_torch/native_io.py) against its plain
numpy versions and against the JAX package's convdr_tpu.native_io, on
inputs made from a seed. Everything here is byte-exact: the same files on
disk, the same arrays back."""

import os
import re

import ml_dtypes
import numpy as np
import pytest

from convdr_torch import native_io as tio
from convdr_tpu import native_io as jio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, ml_dtypes.bfloat16, np.int8]


def rows(rng, n, d, dtype):
    x = rng.randn(n, d).astype(np.float32)
    if dtype == np.int8:
        return np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    return x.astype(dtype)


def same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_library_builds_into_the_port_build_dir():
    assert tio.native_available()
    so = tio.library_path()
    assert os.path.dirname(so) == os.path.join(REPO, "convdr_torch", "build")
    assert re.fullmatch(r"libconvdr_native-[0-9a-f]{12}\.so", os.path.basename(so))
    assert os.path.exists(so)


def test_source_is_the_jax_package_host_library():
    """The port's copy has the same code as native/convdr_native.cpp; only
    comments may differ."""
    def code(path):
        with open(path) as f:
            return [re.sub(r"\s*//.*$", "", ln).rstrip() for ln in f]

    assert code(tio.SOURCE) == code(os.path.join(REPO, "native", "convdr_native.cpp"))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [0, 1, 37])
def test_block_round_trip_and_cross_read(tmp_path, dtype, n):
    rng = np.random.RandomState(n)
    emb = rows(rng, n, 24, dtype)
    ids = rng.randint(0, 1 << 40, size=n).astype(np.int64)
    ours, plain, theirs = (str(tmp_path / f"{k}.cnb") for k in ("ours", "plain", "theirs"))
    tio.write_native_block(ours, emb, ids)
    tio.write_native_block_plain(plain, emb, ids)
    jio.write_native_block(theirs, emb, ids)
    with open(ours, "rb") as a, open(plain, "rb") as b, open(theirs, "rb") as c:
        assert a.read() == b.read() == c.read()
    for read in (lambda p: tio.read_native_block(p, num_threads=3),
                 tio.read_native_block_plain, jio.read_native_block):
        for path in (ours, theirs):
            e2, i2 = read(path)
            same_bits(e2, emb)
            np.testing.assert_array_equal(i2, ids)


def test_float64_rows_are_stored_as_f32(tmp_path):
    emb = np.random.RandomState(1).randn(5, 3)
    path = str(tmp_path / "x.cnb")
    tio.write_native_block(path, emb, np.arange(5))
    e2, _ = jio.read_native_block(path)
    same_bits(e2, emb.astype(np.float32))


@pytest.mark.parametrize("read", [tio.read_native_block, tio.read_native_block_plain],
                         ids=["native", "plain"])
def test_bad_magic_unknown_dtype_and_truncation_raise(tmp_path, read):
    junk = str(tmp_path / "junk.cnb")
    with open(junk, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(IOError):
        read(junk)
    bad_code = str(tmp_path / "code.cnb")
    with open(bad_code, "wb") as f:
        f.write(np.asarray([tio._MAGIC, 2, 2, 7], np.uint64).tobytes())
        f.write(b"\x00" * 64)
    with pytest.raises(IOError, match="dtype code 7"):
        read(bad_code)
    short = str(tmp_path / "short.cnb")
    tio.write_native_block(short, np.ones((4, 8), np.float32), np.arange(4))
    with open(short, "r+b") as f:
        f.truncate(32 + 40)
    with pytest.raises(IOError):
        read(short)


@pytest.mark.parametrize("write", [tio.write_native_block, tio.write_native_block_plain],
                         ids=["native", "plain"])
def test_unknown_row_dtype_and_bad_shapes_are_rejected(tmp_path, write):
    path = str(tmp_path / "x.cnb")
    with pytest.raises(ValueError, match="f32/bf16/int8"):
        write(path, np.zeros((2, 2), np.int32), np.zeros(2, np.int64))
    with pytest.raises(ValueError, match="do not match"):
        write(path, np.zeros((3, 2), np.float32), np.zeros(2, np.int64))


@pytest.mark.parametrize("num_splits", [1, 3, 8])
def test_merge_token_splits_equals_plain_and_jax(tmp_path, num_splits):
    rng = np.random.RandomState(num_splits)
    record_bytes = 4 + 16 * 4
    splits = []
    for s in range(num_splits):
        path = str(tmp_path / f"split{s}")
        with open(path, "wb") as f:
            for _ in range(rng.randint(0, 12)):
                pid = int(rng.randint(0, 1 << 62))
                f.write(pid.to_bytes(8, "big") + rng.bytes(record_bytes))
        splits.append(path)
    max_records = 12 * num_splits
    outs = {}
    for name, merge in (("native", tio.merge_token_splits),
                        ("plain", tio.merge_token_splits_plain),
                        ("jax", jio.merge_token_splits)):
        out = str(tmp_path / f"cache_{name}")
        outs[name] = (merge(splits, out, record_bytes, max_records), open(out, "rb").read())
    for name in ("plain", "jax"):
        np.testing.assert_array_equal(outs[name][0], outs["native"][0])
        assert outs[name][1] == outs["native"][1]


@pytest.mark.parametrize("merge", [tio.merge_token_splits, tio.merge_token_splits_plain],
                         ids=["native", "plain"])
def test_merge_token_splits_rejects_truncated_and_excess_records(tmp_path, merge):
    split = str(tmp_path / "split0")
    with open(split, "wb") as f:
        f.write(b"\x00" * (8 + 8) * 3)
    with pytest.raises(IOError):
        merge([split], str(tmp_path / "out"), 8, 2)  # three records, room for two
    with open(split, "ab") as f:
        f.write(b"\x01" * 5)
    with pytest.raises(IOError):
        merge([split], str(tmp_path / "out"), 8, 10)


def test_merge_topk_host_equals_plain_and_jax():
    rng = np.random.RandomState(5)
    q, k = 6, 40
    # sorted-descending lists over a few distinct values: many cross-list ties
    s_a = -np.sort(-rng.randint(0, 8, (q, k)).astype(np.float32), axis=1)
    s_b = -np.sort(-rng.randint(0, 8, (q, k)).astype(np.float32), axis=1)
    i_a = rng.randint(0, 1000, (q, k)).astype(np.int64)
    i_b = rng.randint(1000, 2000, (q, k)).astype(np.int64)
    want = jio.merge_topk_host(s_a, i_a, s_b, i_b)
    for got in (tio.merge_topk_host(s_a, i_a, s_b, i_b),
                tio.merge_topk_host_plain(s_a, i_a, s_b, i_b)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="one shape"):
        tio.merge_topk_host(s_a, i_a, s_b[:, :5], i_b[:, :5])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "int8"])
def test_gather_file_rows_equals_plain_and_jax(tmp_path, dtype):
    rng = np.random.RandomState(6)
    emb = rows(rng, 300, 20, dtype)
    path = str(tmp_path / "b.cnb")
    tio.write_native_block(path, emb, np.arange(300))
    # runs of consecutive rows, repeats, out of order, and the last row
    idx = np.concatenate([np.arange(10, 30), [299, 5, 5, 0], rng.randint(0, 300, 50)])
    want = jio.gather_file_rows(path, 32, np.dtype(dtype), 20, idx, num_threads=3)
    for got in (tio.gather_file_rows(path, 32, dtype, 20, idx, num_threads=3),
                tio.gather_file_rows_plain(path, 32, dtype, 20, idx)):
        same_bits(got, want)
        same_bits(got, emb[idx])
    assert tio.gather_file_rows(path, 32, dtype, 20, np.zeros(0, np.int64)).shape == (0, 20)
    with pytest.raises(IOError):
        tio.gather_file_rows(path, 32, dtype, 20, np.array([10_000]))
