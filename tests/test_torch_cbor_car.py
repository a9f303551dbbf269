"""The port's CBOR reader and writer (convdr_torch/etl/cbor_car.py) against
the JAX package's: the items of ``tests/test_cbor_car.py``, hypothesis-drawn
nested items (definite and indefinite lengths, byte and text strings, tags,
negative and 64-bit ints, floats, simple values), the paragraph iterator,
and truncated or malformed streams, which must raise the same error."""

import io
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from convdr_torch.etl import cbor_car as tcbor
from convdr_tpu.etl import cbor_car as jcbor

SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def decode_both(data: bytes):
    """Each package's decode of ``data``: its value, or its error's type
    and message."""
    out = []
    for mod in (tcbor, jcbor):
        try:
            out.append(("ok", mod.decode_item(io.BytesIO(data))))
        except (EOFError, ValueError, UnicodeDecodeError, struct.error) as e:
            out.append((type(e).__name__, str(e)))
    return out


# -- an encoder of the whole grammar the decoder reads ----------------------
def head(major, n, width=None):
    """The item head; ``width`` forces a longer argument than needed."""
    if width is None:
        width = 0 if n < 24 else 1 if n < 1 << 8 else 2 if n < 1 << 16 else 4 if n < 1 << 32 else 8
    if width == 0:
        return bytes([(major << 5) | n])
    info = {1: 24, 2: 25, 4: 26, 8: 27}[width]
    return bytes([(major << 5) | info]) + n.to_bytes(width, "big")


def value_of(node):
    """The Python value the decoder should return for a drawn node."""
    kind = node[0]
    if kind in ("int", "bytes", "text", "simple"):
        return node[1]
    if kind == "float":
        return node[2]
    if kind == "tag":
        return value_of(node[2])
    if kind == "array":
        return [value_of(c) for c in node[2]]
    if kind == "map":
        return {value_of(k): value_of(v) for k, v in node[2]}
    raise AssertionError(kind)


def encode(node) -> bytes:
    kind = node[0]
    if kind == "int":
        v = node[1]
        return head(0, v) if v >= 0 else head(1, -1 - v)
    if kind in ("bytes", "text"):
        major = 2 if kind == "bytes" else 3
        raw = node[1] if kind == "bytes" else node[1].encode("utf-8")
        chunks = node[2]
        if chunks is None:
            return head(major, len(raw)) + raw
        # indefinite: definite chunks split at the drawn cut points (text
        # chunks at character boundaries)
        if kind == "text":
            parts = [node[1][a:b] for a, b in zip([0] + chunks, chunks + [len(node[1])])]
            body = b"".join(head(3, len(p.encode())) + p.encode() for p in parts)
        else:
            parts = [raw[a:b] for a, b in zip([0] + chunks, chunks + [len(raw)])]
            body = b"".join(head(2, len(p)) + p for p in parts)
        return bytes([(major << 5) | 31]) + body + b"\xff"
    if kind == "simple":
        return {False: b"\xf4", True: b"\xf5", None: b"\xf6"}[node[1]]
    if kind == "float":
        fmt = {2: ">e", 4: ">f", 8: ">d"}[node[1]]
        return bytes([0xE0 | {2: 25, 4: 26, 8: 27}[node[1]]]) + struct.pack(fmt, node[2])
    if kind == "tag":
        return head(6, node[1]) + encode(node[2])
    if kind in ("array", "map"):
        major = 4 if kind == "array" else 5
        items = node[2] if kind == "array" else [x for kv in node[2] for x in kv]
        body = b"".join(encode(c) for c in items)
        if node[1]:  # indefinite
            return bytes([(major << 5) | 31]) + body + b"\xff"
        return head(major, len(node[2])) + body
    raise AssertionError(kind)


def cuts(n):
    return st.lists(st.integers(0, n), max_size=3).map(lambda c: sorted(set(c)))


ints = st.integers(-(1 << 64), (1 << 64) - 1).map(lambda v: ("int", v))
texts = st.text(max_size=12).flatmap(
    lambda s: st.one_of(st.none(), cuts(len(s))).map(lambda c: ("text", s, c)))
blobs = st.binary(max_size=12).flatmap(
    lambda b: st.one_of(st.none(), cuts(len(b))).map(lambda c: ("bytes", b, c)))
simples = st.sampled_from([False, True, None]).map(lambda v: ("simple", v))
halves = st.floats(width=16, allow_nan=False).map(lambda v: ("float", 2, v))
singles = st.floats(width=32, allow_nan=False).map(lambda v: ("float", 4, v))
doubles = st.floats(allow_nan=False).map(lambda v: ("float", 8, v))
keys = st.one_of(ints, st.text(max_size=6).map(lambda s: ("text", s, None)))
leaves = st.one_of(ints, texts, blobs, simples, halves, singles, doubles)
nodes = st.recursive(
    leaves,
    lambda inner: st.one_of(
        st.tuples(st.just("array"), st.booleans(), st.lists(inner, max_size=4)),
        st.tuples(st.just("map"), st.booleans(),
                  st.lists(st.tuples(keys, inner), max_size=3,
                           unique_by=lambda kv: value_of(kv[0]))),
        st.tuples(st.just("tag"), st.integers(0, 1 << 40), inner),
    ),
    max_leaves=12,
)


@SETTINGS
@given(nodes)
def test_decoders_agree_on_drawn_items(node):
    data = encode(node)
    (tk, tv), (jk, jv) = decode_both(data)
    assert tk == jk == "ok"
    assert tv == jv == value_of(node)


@SETTINGS
@given(nodes, st.data())
def test_truncated_streams_raise_the_same_error(node, data):
    """Any proper prefix of an item: both decoders raise, the same error."""
    blob = encode(node)
    cut = data.draw(st.integers(0, len(blob) - 1))
    t, j = decode_both(blob[:cut])
    assert t == j and t[0] == "EOFError"


plain = st.recursive(
    st.one_of(st.integers(-(1 << 64), (1 << 64) - 1), st.text(max_size=10),
              st.binary(max_size=10), st.booleans(), st.none()),
    lambda inner: st.lists(inner, max_size=4),
    max_leaves=12,
)


@SETTINGS
@given(plain)
def test_encoders_write_the_same_bytes_and_round_trip(obj):
    blob = tcbor.encode_item(obj)
    assert blob == jcbor.encode_item(obj)
    assert tcbor.decode_item(io.BytesIO(blob)) == obj


@pytest.mark.parametrize("obj", [0, 23, 24, 255, 65536, -1, -100, "hello", b"bytes", True,
                                 False, None, [], [1, [2, "x"]]])
def test_round_trip_the_jax_cases(obj):
    assert tcbor.encode_item(obj) == jcbor.encode_item(obj)
    assert tcbor.decode_item(io.BytesIO(tcbor.encode_item(obj))) == obj


@pytest.mark.parametrize("hexed", [
    "00", "1903e8", "20", "6161", "83010203", "7f657374726561646d696e67ff",
    "c074323031332d30332d32315432303a30343a30305a", "a26161016162820203",
    "bf61610161629f0203ffff", "f97c00", "fa47c35000", "fb3ff199999999999a", "f0", "f818",
])
def test_rfc8949_vectors_decode_alike(hexed):
    t, j = decode_both(bytes.fromhex(hexed))
    assert t == j and t[0] == "ok"


@pytest.mark.parametrize("hexed", [
    "1c", "3d", "5e", "7e", "9d", "bc", "dd", "fc",  # reserved additional infos
    "", "19", "1a0000", "5803ab", "62c3", "9f01", "bf6161", "f8",  # truncated
    "62ffff",  # bad UTF-8
])
def test_malformed_streams_raise_alike(hexed):
    t, j = decode_both(bytes.fromhex(hexed))
    assert t == j and t[0] != "ok"


def test_encoders_refuse_alike():
    for mod in (tcbor, jcbor):
        with pytest.raises(TypeError):
            mod.encode_item({"a": 1})
        with pytest.raises(TypeError):
            mod.encode_item(1.5)


@SETTINGS
@given(st.lists(st.tuples(st.one_of(st.text(min_size=1, max_size=8),
                                    st.text(min_size=1, max_size=8).map(str.encode)),
                          st.lists(st.one_of(
                              st.tuples(st.just(0), st.text(max_size=8)).map(list),
                              st.tuples(st.just(1), st.text(max_size=4), st.text(max_size=4),
                                        st.text(max_size=8)).map(list),
                              st.text(max_size=4)), max_size=4)),
                max_size=6),
       st.booleans())
def test_iter_paragraphs_matches_jax(paras, header):
    """A CAR paragraphs stream (an optional v2 header, non-paragraph items
    between paragraphs): the same ids and texts from both iterators."""
    buf = io.BytesIO()
    if header:
        buf.write(tcbor.encode_item([0, "header", [1]]))
    for i, (pid, bodies) in enumerate(paras):
        buf.write(tcbor.encode_item([1, pid, bodies]))
        if i % 2:
            buf.write(tcbor.encode_item([2, "skip me"]))
    got = []
    for mod in (tcbor, jcbor):
        buf.seek(0)
        got.append([(p.para_id, p.get_text()) for p in mod.iter_paragraphs(buf)])
    assert got[0] == got[1]
    assert [pid for pid, _ in got[0]] == [
        p.decode() if isinstance(p, bytes) else p for p, _ in paras]
