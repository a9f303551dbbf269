"""Minimal CBOR decoder + TREC-CAR paragraph iterator.

The counterpart of ``convdr_tpu/etl/cbor_car.py``, line for line in
behaviour (the port keeps its own copy: it imports nothing of the JAX
package).

The reference consumes TREC-CAR paragraph corpora through the external
``trec-car-tools`` package (data/preprocess_cast19.py:75-86).
This hermetic environment has no such dependency, so the needed subset is
implemented here:

  * a streaming CBOR (RFC 8949) decoder covering the major types CAR files
    use (uints, negints, byte/text strings incl. indefinite, arrays, maps,
    tags, simple values);
  * :func:`iter_paragraphs` yielding ``CarParagraph(para_id, get_text())``
    from a CAR v1.5/v2.0 paragraphs file, where a paragraph is encoded as
    ``[1, <para_id>, [<body>...]]`` and each body is ``[0, text]`` (ParaText)
    or ``[1, page, page_id, anchor_text]`` (ParaLink; the anchor text is what
    ``get_text()`` contributes, matching trec-car-tools).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import Any, BinaryIO, Iterator, List, Optional

_BREAK = object()


class CBORDecodeError(ValueError):
    pass


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise EOFError("truncated CBOR stream")
    return data


def _read_uint(f: BinaryIO, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return _read_exact(f, 1)[0]
    if info == 25:
        return struct.unpack(">H", _read_exact(f, 2))[0]
    if info == 26:
        return struct.unpack(">I", _read_exact(f, 4))[0]
    if info == 27:
        return struct.unpack(">Q", _read_exact(f, 8))[0]
    raise CBORDecodeError(f"invalid additional info {info}")


def decode_item(f: BinaryIO) -> Any:
    """Decode one CBOR data item from the stream."""
    head = f.read(1)
    if not head:
        raise EOFError("end of CBOR stream")
    byte = head[0]
    major, info = byte >> 5, byte & 0x1F

    if major == 0:  # unsigned int
        return _read_uint(f, info)
    if major == 1:  # negative int
        return -1 - _read_uint(f, info)
    if major == 2:  # byte string
        if info == 31:  # indefinite
            chunks = []
            while True:
                item = decode_item(f)
                if item is _BREAK:
                    return b"".join(chunks)
                chunks.append(item)
        return _read_exact(f, _read_uint(f, info))
    if major == 3:  # text string
        if info == 31:
            chunks = []
            while True:
                item = decode_item(f)
                if item is _BREAK:
                    return "".join(chunks)
                chunks.append(item)
        return _read_exact(f, _read_uint(f, info)).decode("utf-8")
    if major == 4:  # array
        if info == 31:
            out: List[Any] = []
            while True:
                item = decode_item(f)
                if item is _BREAK:
                    return out
                out.append(item)
        return [decode_item(f) for _ in range(_read_uint(f, info))]
    if major == 5:  # map
        if info == 31:
            d = {}
            while True:
                key = decode_item(f)
                if key is _BREAK:
                    return d
                d[key] = decode_item(f)
            return d
        return {decode_item(f): decode_item(f) for _ in range(_read_uint(f, info))}
    if major == 6:  # tag: decode and discard the tag number
        _read_uint(f, info)
        return decode_item(f)
    if major == 7:  # simple / float / break
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22:
            return None
        if info == 23:
            return None  # undefined
        if info == 25:
            return struct.unpack(">e", _read_exact(f, 2))[0]
        if info == 26:
            return struct.unpack(">f", _read_exact(f, 4))[0]
        if info == 27:
            return struct.unpack(">d", _read_exact(f, 8))[0]
        if info == 31:
            return _BREAK
        if info < 24:
            return info
        if info == 24:
            return _read_exact(f, 1)[0]
    raise CBORDecodeError(f"unsupported CBOR header byte {byte:#x}")


@dataclasses.dataclass
class CarParagraph:
    para_id: str
    bodies: List[Any]

    def get_text(self) -> str:
        """Concatenate body texts; links contribute their anchor text."""
        parts: List[str] = []
        for body in self.bodies:
            if isinstance(body, str):
                parts.append(body)
            elif isinstance(body, list) and body:
                if body[0] == 0 and len(body) >= 2:  # ParaText [0, text]
                    parts.append(str(body[1]))
                elif body[0] == 1:  # ParaLink [...last item is anchor text]
                    parts.append(str(body[-1]))
        return "".join(parts)


def _as_str(x: Any) -> str:
    return x.decode("utf-8") if isinstance(x, bytes) else str(x)


def iter_paragraphs(f: BinaryIO) -> Iterator[CarParagraph]:
    """Yield paragraphs from a CAR paragraphs cbor file.

    Tolerates an optional leading header item (CAR v2 files start with a
    ``[0, ...]`` header) and skips non-paragraph items.
    """
    while True:
        try:
            item = decode_item(f)
        except EOFError:
            return
        if not isinstance(item, list) or not item:
            continue
        if item[0] == 1 and len(item) >= 3:  # [1, para_id, [bodies]]
            yield CarParagraph(
                para_id=_as_str(item[1]),
                bodies=item[2] if isinstance(item[2], list) else [],
            )


# -- tiny encoder (tests / fixture construction) ----------------------------
def encode_item(obj: Any) -> bytes:
    """Encode python data to CBOR (subset: ints, str, bytes, lists)."""
    out = io.BytesIO()

    def head(major: int, n: int) -> bytes:
        if n < 24:
            return bytes([(major << 5) | n])
        if n < 1 << 8:
            return bytes([(major << 5) | 24, n])
        if n < 1 << 16:
            return bytes([(major << 5) | 25]) + struct.pack(">H", n)
        if n < 1 << 32:
            return bytes([(major << 5) | 26]) + struct.pack(">I", n)
        return bytes([(major << 5) | 27]) + struct.pack(">Q", n)

    def enc(x: Any) -> None:
        if isinstance(x, bool):
            out.write(bytes([0xF5 if x else 0xF4]))
        elif isinstance(x, int):
            if x >= 0:
                out.write(head(0, x))
            else:
                out.write(head(1, -1 - x))
        elif isinstance(x, bytes):
            out.write(head(2, len(x)))
            out.write(x)
        elif isinstance(x, str):
            b = x.encode("utf-8")
            out.write(head(3, len(b)))
            out.write(b)
        elif isinstance(x, list):
            out.write(head(4, len(x)))
            for item in x:
                enc(item)
        elif x is None:
            out.write(bytes([0xF6]))
        else:
            raise TypeError(f"cannot encode {type(x)}")

    enc(obj)
    return out.getvalue()
