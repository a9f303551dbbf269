"""The port's zstd decoder (``convdr_torch/csrc/host/zstd.cpp``) against the
``zstandard`` library: the same bytes back at levels 1, 3 and 19 and at a
window log of 27, with and without the checksum and the content size, on
empty, RLE-heavy, random, f32-weight and multi-block text data; faults
(a wrong checksum, truncation, a dictionary id, garbage) raise
``ValueError``; a fuzz over random and mutated frames only ever returns or
raises ``ValueError``. Also the raw-block encoder (read by ``zstandard``),
and CRC-32C (OCDBT's checksum)."""

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from convdr_torch import native_io


def _data(kind: str) -> bytes:
    rng = np.random.RandomState(7)
    if kind == "empty":
        return b""
    if kind == "rle":
        return b"a" * 200_000 + b"bc" * 5 + b"\x00" * 150_000 + rng.bytes(50)
    if kind == "random":
        return rng.bytes(300_000)
    if kind == "f32":  # weights: the mantissas are noise, the exponents repeat
        return (rng.randn(90_000) * 0.02).astype(np.float32).tobytes()
    if kind == "text":  # several blocks of matches over a large window
        words = "the history of jazz music in new orleans and blues".split()
        return " ".join(rng.choice(words, 80_000)).encode()
    raise ValueError(kind)


KINDS = ("empty", "rle", "random", "f32", "text")


def _decode(frame: bytes, size: int) -> bytes:
    return native_io.zstd_decompress(frame, size=size).tobytes()


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("checksum,content_size", [(True, True), (False, False),
                                                   (True, False), (False, True)])
def test_decoder_equals_zstandard(level, kind, checksum, content_size):
    data = _data(kind)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=content_size).compress(data)
    assert _decode(frame, len(data)) == data
    declared = native_io.zstd_content_size(frame)
    assert declared == (len(data) if content_size else None)


@pytest.mark.parametrize("kind", KINDS)
def test_decoder_window_log_27(kind):
    data = _data(kind)
    params = zstandard.ZstdCompressionParameters.from_level(19, window_log=27,
                                                            write_checksum=True)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert int.from_bytes(frame[4:5], "little") & 4  # the checksum flag
    assert _decode(frame, len(data)) == data


def test_decoder_streamed_frame_and_frame_sequence():
    data = _data("text")
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    streamed = b"".join(cobj.compress(data[i:i + 10_000]) for i in range(0, len(data), 10_000))
    streamed += cobj.flush()
    assert native_io.zstd_content_size(streamed) is None
    assert _decode(streamed, len(data)) == data
    # two frames with a skippable frame between them decode to their concatenation
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    two = (zstandard.ZstdCompressor(level=1).compress(data[:1000]) + skip
           + zstandard.ZstdCompressor(level=19).compress(data[1000:]))
    assert _decode(two, len(data)) == data


def test_decoder_into_a_given_array():
    weights = (np.random.RandomState(1).randn(64, 33) * 0.02).astype(np.float32)
    frame = zstandard.ZstdCompressor(level=1).compress(weights.tobytes())
    out = np.empty_like(weights)
    native_io.zstd_decompress(frame, out=out)
    assert np.array_equal(out, weights)
    with pytest.raises(ValueError, match="dst_too_small"):
        native_io.zstd_decompress(frame, out=np.empty((64, 32), np.float32))
    with pytest.raises(ValueError, match="decoded"):
        native_io.zstd_decompress(frame, out=np.empty((64, 34), np.float32))


def test_wrong_checksum_raises():
    data = _data("text")
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0x5A
    with pytest.raises(ValueError, match="checksum_mismatch"):
        _decode(bytes(frame), len(data))


@pytest.mark.parametrize("kind", ["text", "f32", "rle"])
def test_truncated_frames_raise(kind):
    data = _data(kind)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (0, 3, 5, len(frame) // 3, len(frame) // 2, len(frame) - 5, len(frame) - 1):
        with pytest.raises(ValueError):
            _decode(frame[:cut], len(data))


def test_header_faults_raise():
    frame = bytearray(zstandard.ZstdCompressor(level=1).compress(b"abc" * 100))
    with pytest.raises(ValueError, match="bad_magic"):
        _decode(b"\x00" + bytes(frame[1:]), 300)
    bad = bytearray(frame)
    bad[4] |= 0x08  # the reserved bit
    with pytest.raises(ValueError, match="reserved_bit_set"):
        _decode(bytes(bad), 300)
    # a one-byte dictionary id field (flag 1), then one raw block "abc"
    def with_dict(did):
        return b"\x28\xb5\x2f\xfd\x01\x00" + bytes([did]) + bytes([3 << 3 | 1, 0, 0]) + b"abc"

    assert zstandard.ZstdDecompressor().decompressobj().decompress(with_dict(0)) == b"abc"
    assert _decode(with_dict(0), 3) == b"abc"
    with pytest.raises(ValueError, match="dictionary_unsupported"):
        _decode(with_dict(1), 3)


def test_raw_encoder_read_by_zstandard():
    for kind in KINDS:
        data = _data(kind)
        frame = native_io.zstd_compress_raw(data)
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert native_io.zstd_content_size(frame) == len(data)
        assert _decode(frame, len(data)) == data


def test_crc32c_known_values():
    assert native_io.crc32c(b"") == 0
    assert native_io.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert native_io.crc32c(b"456789", native_io.crc32c(b"123")) == 0xE3069283


_SEEDS = [zstandard.ZstdCompressor(level=lvl, write_checksum=ck).compress(_data(kind)[:20_000])
          for lvl, ck, kind in ((1, True, "text"), (19, False, "f32"), (3, True, "rle"))]


def _try(frame: bytes) -> None:
    try:
        native_io.zstd_decompress(frame, size=40_000)
    except ValueError:
        pass


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(min_size=0, max_size=400))
def test_fuzz_random_bytes(blob):
    _try(blob)
    _try(b"\x28\xb5\x2f\xfd" + blob)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, len(_SEEDS) - 1), st.lists(st.tuples(st.integers(0, 1 << 30),
                                                           st.integers(0, 255)),
                                                 min_size=1, max_size=6),
       st.integers(0, 1 << 30))
def test_fuzz_mutated_frames(which, edits, cut):
    frame = bytearray(_SEEDS[which])
    for pos, val in edits:
        frame[pos % len(frame)] = val
    _try(bytes(frame))
    _try(bytes(frame[:cut % (len(frame) + 1)]))
