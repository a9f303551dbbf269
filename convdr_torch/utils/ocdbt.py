"""tensorstore's OCDBT key-value format: a reader and a small writer.

The JAX package's orbax checkpoints are OCDBT databases (the format
documented at https://google.github.io/tensorstore/kvstore/ocdbt/index.html):
a ``manifest.ocdbt`` holding the configuration and the version tree, whose
newest version names the root of a b-tree of keys; b-tree nodes and large
values live in data files under ``d/`` (or under a sub-database's dir, as
orbax's ``ocdbt.process_<i>/d/``). Every manifest and node is an envelope:

    magic (u32 big-endian) | length (u64 LE, the whole envelope) |
    format version (varint, 0) | compression (varint: 0 none, 1 zstd) |
    body (zstd frame when compressed) | CRC-32C of all before (u32 LE)

Inside a body, integers are LEB128 varints and the per-entry fields are
stored column by column. A data file is named by a table of paths
(prefix-compressed against the previous path), split into a base path that
becomes the transitive prefix of the files a child node names, and a
relative path.

:class:`OcdbtReader` verifies each envelope's checksum, decodes leaf and
interior nodes with their prefix-compressed keys, and returns inline values
and values stored in data files (memory-mapped, no copy). :func:`write_ocdbt`
writes a database that tensorstore reads: one manifest, uncompressed nodes
(interior ones when the keys need them) and one data file for the values
larger than the inline limit. zstd and CRC-32C come from the port's host
library (:mod:`convdr_torch.native_io`).
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from convdr_torch import native_io

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
# an absent b-tree root (empty database): offset and length are all ones
_MISSING = (1 << 64) - 1
MAX_INLINE_VALUE_BYTES = 1024  # orbax's setting (tensorstore_utils.py)
NODE_TARGET_BYTES = 1 << 20  # the writer splits a level into nodes of about this size


# ---------------------------------------------------------------------------
# envelopes and fields
# ---------------------------------------------------------------------------
class _Cursor:
    def __init__(self, buf, what: str):
        self.buf = memoryview(buf)
        self.pos = 0
        self.what = what

    def fail(self, msg: str):
        raise ValueError(f"OCDBT {self.what}: {msg}")

    def u8(self) -> int:
        if self.pos >= len(self.buf):
            self.fail("truncated")
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail("truncated")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_envelope(buf, magic: int, what: str, max_bytes: int = 1 << 31) -> bytes:
    """The body of one manifest or node after its header, its checksum and
    (when compressed) zstd are checked and undone."""
    buf = memoryview(buf)
    if len(buf) < 18:
        raise ValueError(f"OCDBT {what}: {len(buf)} bytes is too short")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise ValueError(f"OCDBT {what}: header says {length} bytes, have {len(buf)}")
    want = struct.unpack("<I", buf[-4:])[0]
    got = native_io.crc32c(buf[:-4])
    if want != got:
        raise ValueError(f"OCDBT {what}: CRC-32C {got:#010x} != stored {want:#010x}")
    cur = _Cursor(buf[:-4], what)
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version} is not supported")
    method = cur.varint()
    body = buf[cur.pos:-4]
    if method == 0:
        return bytes(body)
    if method != 1:
        raise ValueError(f"OCDBT {what}: compression method {method} is not supported")
    size = native_io.zstd_content_size(body)
    if size is not None and size > max_bytes:
        raise ValueError(f"OCDBT {what}: {size} decoded bytes exceed {max_bytes}")
    try:
        return native_io.zstd_decompress(body, size=size or max_bytes).tobytes()
    except ValueError as e:
        raise ValueError(f"OCDBT {what}: {e}") from e


def encode_envelope(magic: int, body: bytes) -> bytes:
    """An uncompressed envelope around ``body``."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4)
    data = head + _varint(0) + _varint(0) + body
    return data + struct.pack("<I", native_io.crc32c(data))


# ---------------------------------------------------------------------------
# configuration, data file tables, keys
# ---------------------------------------------------------------------------
@dataclass
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Tuple[int, int]  # (method, zstd level)


def _read_config(cur: _Cursor) -> Config:
    uid = bytes(cur.take(16))
    kind = cur.varint()
    max_inline = cur.varint()
    max_node = cur.varint()
    arity = cur.u8()
    method = cur.varint()
    level = 0
    if method == 1:
        level = struct.unpack("<i", cur.take(4))[0]
    elif method != 0:
        cur.fail(f"compression method {method} is not supported")
    return Config(uid, kind, max_inline, max_node, arity, (method, level))


def _write_config(cfg: Config) -> bytes:
    out = (cfg.uuid + _varint(cfg.manifest_kind) + _varint(cfg.max_inline_value_bytes)
           + _varint(cfg.max_decoded_node_bytes) + bytes([cfg.version_tree_arity_log2])
           + _varint(cfg.compression[0]))
    if cfg.compression[0] == 1:
        out += struct.pack("<i", cfg.compression[1])
    return out


def _read_file_table(cur: _Cursor, transitive: str) -> List[Tuple[str, str]]:
    """[(base path, relative path)], the base path prefixed with the
    transitive path of the node or manifest that holds the table."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("data file path prefix longer than the previous path")
        path = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        if base[i] > len(path):
            cur.fail("data file base path longer than its path")
        files.append((transitive + path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return files


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _write_file_table(files: List[Tuple[str, str]]) -> bytes:
    paths = [(b + r).encode() for b, r in files]
    prefix = [_common_prefix(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    out = _varint(len(paths)) + b"".join(_varint(p) for p in prefix)
    out += b"".join(_varint(len(p) - q) for p, q in zip(paths, [0] + prefix))
    out += b"".join(_varint(len(b.encode())) for b, _ in files)
    out += b"".join(p[q:] for p, q in zip(paths, [0] + prefix))
    return out


def _read_keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """The keys of a node (prefix-compressed against the previous key) and,
    in an interior node, each child's subtree common prefix length, whose
    column sits between the key lengths and the key bytes."""
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("key prefix longer than the previous key")
        prev = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        keys.append(prev)
    return keys, common


def _write_keys(keys: List[bytes], interior: bool) -> bytes:
    """Inverse of :func:`_read_keys`; interior nodes get a subtree common
    prefix of 0 (their children store whole keys)."""
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    out = b"".join(_varint(p) for p in prefix)
    out += b"".join(_varint(len(k) - q) for k, q in zip(keys, [0] + prefix))
    if interior:
        out += b"".join(_varint(0) for _ in keys)
    out += b"".join(k[q:] for k, q in zip(keys, [0] + prefix))
    return out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
@dataclass
class _Ref:
    """Where a node or a value lives: a data file, an offset and a length."""

    base: str
    rel: str
    offset: int
    length: int


class OcdbtReader:
    """Read-only view of the OCDBT database in ``path`` (the newest
    version of its root manifest).

    ``keys()`` lists every key (str, sorted); ``read(key)`` returns its
    value as a memoryview: inline values are copies held in memory, values
    in data files are slices of a memory map."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(os.path.join(self.path, MANIFEST_FILE), "rb") as f:
            raw = f.read()
        cur = _Cursor(decode_envelope(raw, MANIFEST_MAGIC, "manifest"), "manifest")
        self.config = _read_config(cur)
        if self.config.manifest_kind != 0:
            raise ValueError(
                f"OCDBT manifest kind {self.config.manifest_kind} (numbered manifests) "
                "is not supported")
        files = _read_file_table(cur, "")
        n = cur.varint()
        if n == 0:
            raise ValueError("OCDBT manifest holds no version")
        gen = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(n)  # num_tree_bytes
        cur.varints(n)  # num_indirect_value_bytes
        [cur.u64() for _ in range(n)]  # commit times
        # the version tree's interior nodes (older versions) follow; only
        # the newest version is read
        self.generation = gen[-1]
        self._maps: Dict[str, mmap.mmap] = {}
        self._entries: Dict[bytes, object] = {}
        if num_keys[-1] == 0 or off[-1] == _MISSING:
            return
        if fid[-1] >= len(files):
            raise ValueError("OCDBT manifest names a data file it does not list")
        root = _Ref(*files[fid[-1]], off[-1], length[-1])
        self._walk(root, height[-1], b"")

    def _file(self, base: str, rel: str) -> mmap.mmap:
        name = base + rel
        m = self._maps.get(name)
        if m is None:
            full = os.path.normpath(os.path.join(self.path, name))
            if not full.startswith(self.path + os.sep):
                raise ValueError(f"OCDBT data file {name!r} lies outside the database")
            with open(full, "rb") as f:
                m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._maps[name] = m
        return m

    def _bytes(self, ref: _Ref) -> memoryview:
        m = self._file(ref.base, ref.rel)
        if ref.offset + ref.length > len(m):
            raise ValueError(
                f"OCDBT reference {ref.base}{ref.rel}@{ref.offset}+{ref.length} runs past "
                f"the file's {len(m)} bytes")
        return memoryview(m)[ref.offset:ref.offset + ref.length]

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        body = decode_envelope(self._bytes(ref), NODE_MAGIC, "b-tree node",
                               self.config.max_decoded_node_bytes)
        cur = _Cursor(body, "b-tree node")
        if cur.u8() != height:
            cur.fail(f"height differs from its reference's ({height})")
        # the files a node names are relative to the base path of its own file
        files = _read_file_table(cur, ref.base)
        n = cur.varint()
        keys, common = _read_keys(cur, n, interior=height > 0)
        if height == 0:
            lengths = cur.varints(n)
            kinds = [cur.u8() for _ in range(n)]
            if any(k > 1 for k in kinds):
                cur.fail("unknown value kind")
            m = sum(kinds)
            fid, off = cur.varints(m), cur.varints(m)
            j = 0
            for key, kind, ln in zip(keys, kinds, lengths):
                if kind:
                    if fid[j] >= len(files):
                        cur.fail("value names a data file the node does not list")
                    self._entries[prefix + key] = _Ref(*files[fid[j]], off[j], ln)
                    j += 1
                else:
                    self._entries[prefix + key] = bytes(cur.take(ln))
            return
        fid, off, length = cur.varints(n), cur.varints(n), cur.varints(n)
        for i in range(n):
            if common[i] > len(keys[i]) or fid[i] >= len(files):
                cur.fail("malformed child reference")
            self._walk(_Ref(*files[fid[i]], off[i], length[i]), height - 1,
                       prefix + keys[i][:common[i]])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def read(self, key: str) -> memoryview:
        entry = self._entries.get(key.encode())
        if entry is None:
            raise KeyError(key)
        if isinstance(entry, _Ref):
            return self._bytes(entry)
        return memoryview(entry)

    def close(self) -> None:
        for m in self._maps.values():
            try:
                m.close()
            except BufferError:  # a caller still holds a view
                pass
        self._maps.clear()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
def _leaf_body(keys: List[bytes], lengths: List[int], offsets: List[Optional[int]],
               inline: List[bytes], files) -> bytes:
    """A leaf node: the values with an offset live in the data file, the
    ``inline`` ones (in key order) in the node."""
    indirect = [o is not None for o in offsets]
    return (b"\x00" + _write_file_table(files if any(indirect) else [])
            + _varint(len(keys)) + _write_keys(keys, False)
            + b"".join(_varint(n) for n in lengths) + bytes(indirect)
            + b"".join(_varint(0) for o in offsets if o is not None)
            + b"".join(_varint(o) for o in offsets if o is not None)
            + b"".join(inline))


@dataclass
class _Written:
    """A node in the data file with its subtree's statistics."""

    first_key: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


def _interior_body(height: int, group: List[_Written], files) -> bytes:
    """An interior node over ``group``; children store whole keys."""
    cols = [[g.offset for g in group], [g.length for g in group],
            [g.num_keys for g in group], [g.tree_bytes for g in group],
            [g.indirect_bytes for g in group]]
    return (bytes([height]) + _write_file_table(files) + _varint(len(group))
            + _write_keys([g.first_key for g in group], True)
            + b"".join(_varint(0) for _ in group)
            + b"".join(_varint(v) for col in cols for v in col))


def write_ocdbt(path: str, items: Iterable[Tuple[str, object]],
                node_target_bytes: int = NODE_TARGET_BYTES) -> None:
    """Write ``items`` (key, value) as a new OCDBT database in ``path``:
    the values above :data:`MAX_INLINE_VALUE_BYTES` go to one data file
    ``d/<hex>``, followed by the uncompressed b-tree nodes (leaves of about
    ``node_target_bytes`` each and interior levels over them), then
    ``manifest.ocdbt``. A value may be bytes or a function that returns
    them, called when the value is written, so that large values need not
    all be held at once. The manifest is written last, through a temporary
    name, so a reader never sees a database whose nodes are missing."""
    entries = sorted((k.encode(), v) for k, v in items)
    if not entries:
        raise ValueError("write_ocdbt needs at least one key")
    for a, b in zip(entries, entries[1:]):
        if a[0] == b[0]:
            raise ValueError(f"duplicate OCDBT key {a[0].decode()!r}")
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    files = [("", f"d/{uuid_mod.uuid4().hex}")]
    with open(os.path.join(path, files[0][1]), "wb") as f:
        def put(blob) -> int:
            start = f.tell()
            f.write(blob)
            return start

        level: List[_Written] = []
        i = 0
        while i < len(entries):
            keys, lengths, offsets, inline, size = [], [], [], [], 0
            while i < len(entries) and (not keys or size < node_target_bytes):
                key, value = entries[i]
                value = value() if callable(value) else value
                keys.append(key)
                lengths.append(len(value))
                if len(value) > MAX_INLINE_VALUE_BYTES:
                    offsets.append(put(value))
                    size += len(key) + 8
                else:
                    offsets.append(None)
                    inline.append(bytes(value))
                    size += len(key) + len(value)
                i += 1
            node = encode_envelope(NODE_MAGIC, _leaf_body(keys, lengths, offsets, inline, files))
            level.append(_Written(keys[0], put(node), len(node), len(keys), len(node),
                                  sum(n for n, o in zip(lengths, offsets) if o is not None)))
        height = 0
        per = max(2, node_target_bytes // 64)
        while len(level) > 1:
            height += 1
            parents = []
            for i in range(0, len(level), per):
                group = level[i:i + per]
                node = encode_envelope(NODE_MAGIC, _interior_body(height, group, files))
                parents.append(_Written(
                    group[0].first_key, put(node), len(node),
                    sum(g.num_keys for g in group),
                    len(node) + sum(g.tree_bytes for g in group),
                    sum(g.indirect_bytes for g in group)))
            level = parents
    root = level[0]
    cfg = Config(uuid_mod.uuid4().bytes, 0, MAX_INLINE_VALUE_BYTES, 100_000_000, 4, (0, 0))
    body = (_write_config(cfg) + _write_file_table(files)
            + _varint(1)  # one version: generation 1
            + _varint(1) + bytes([height]) + _varint(0) + _varint(root.offset)
            + _varint(root.length) + _varint(root.num_keys) + _varint(root.tree_bytes)
            + _varint(root.indirect_bytes) + struct.pack("<Q", time.time_ns())
            + _varint(0))  # no version tree nodes
    manifest = os.path.join(path, MANIFEST_FILE)
    with open(manifest + ".tmp", "wb") as f:
        f.write(encode_envelope(MANIFEST_MAGIC, body))
    os.replace(manifest + ".tmp", manifest)
