"""Flat HDF5 files of named arrays, read and written without h5py.

Human3.6M's ``annot_export.h5`` is a flat file: one group holding one
dataset per column, each a contiguous array of fixed-point, floating-point
or fixed-length byte-string elements.  h5py reads it where it is installed
(``data/human36m.py`` prefers it); where it is not, :func:`read_columns`
reads the subset of the HDF5 format that h5py writes for such a file by
default: superblock version 0 or 1, a root group stored as a symbol table
(a version 1 B-tree of symbol-table nodes, names in a local heap), version
1 object headers (with continuation blocks), dataspace, datatype and
version 3 data-layout messages, contiguous or compact storage.  Anything
else (chunked or compressed data, nested groups, new-style groups)
raises ``ValueError``.

:func:`write_columns` writes such a file for exactly that subset (the
Human3.6M export of ``data/prep/process.py`` on a machine without h5py):
superblock version 0 with 8-byte offsets and lengths, the root group as a
symbol table (one version 1 B-tree leaf over symbol-table nodes of at
most 8 names, the names in a local heap), a version 1 object header a
column (dataspace, datatype, version 3 contiguous layout) and its data
stored contiguously, little-endian.  The columns are integers, floats or
fixed-length byte strings; they arrive one at a time from an iterable, and
each is on disk before the next is made.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        if data[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file (no signature at offset 0)")
        version = data[8]
        if version not in (0, 1):
            raise ValueError(f"HDF5 superblock version {version} is not "
                             f"read (only 0 and 1)")
        if data[13] != 8 or data[14] != 8:
            raise ValueError("only 8-byte offsets and lengths are read")
        pos = 24 + (4 if version == 1 else 0)
        self.base = self.u64(pos)
        self.root_header = self.u64(pos + 32 + 8)

    def u(self, pos, n):
        return int.from_bytes(self.d[pos:pos + n], "little")

    def u64(self, pos):
        return self.u(pos, 8)

    def addr(self, pos):
        return self.base + self.u64(pos)

    def messages(self, header):
        """(type, data offset, size) of each message of a version 1 object
        header, following continuation messages."""
        if self.d[header] != 1:
            raise ValueError(f"object header version {self.d[header]} is "
                             f"not read (only 1)")
        n = self.u(header + 2, 2)
        blocks = [(header + 16, self.u(header + 8, 4))]
        out = []
        while blocks and len(out) < n:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and len(out) < n:
                mtype, msize = self.u(pos, 2), self.u(pos + 2, 2)
                out.append((mtype, pos + 8, msize))
                if mtype == 0x10:
                    blocks.append((self.addr(pos + 8), self.u64(pos + 16)))
                pos += 8 + msize
        return out

    def group(self, header) -> Dict[str, int]:
        """name -> object header address of a symbol-table group."""
        for mtype, pos, _ in self.messages(header):
            if mtype == 0x11:
                btree, heap = self.addr(pos), self.addr(pos + 8)
                break
        else:
            raise ValueError("the root group has no symbol table (a "
                             "new-style group): not read")
        if self.d[heap:heap + 4] != b"HEAP":
            raise ValueError("no local heap where the group says")
        names = self.addr(heap + 24)
        out = {}
        self._btree(btree, names, out)
        return out

    def _btree(self, node, names, out):
        if self.d[node:node + 4] != b"TREE" or self.d[node + 4] != 0:
            raise ValueError("no group B-tree node where the group says")
        level, used = self.d[node + 5], self.u(node + 6, 2)
        for k in range(used):
            child = self.addr(node + 24 + 8 + 16 * k)
            if level > 0:
                self._btree(child, names, out)
                continue
            if self.d[child:child + 4] != b"SNOD":
                raise ValueError("no symbol-table node where the B-tree says")
            for e in range(self.u(child + 6, 2)):
                entry = child + 8 + 40 * e
                start = names + self.u64(entry)
                name = self.d[start:self.d.index(b"\0", start)].decode()
                out[name] = self.addr(entry + 8)

    def dtype(self, pos) -> np.dtype:
        cls, flags, size = self.d[pos] & 0x0F, self.d[pos + 1], self.u(
            pos + 4, 4)
        order = ">" if flags & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if flags & 0x08 else 'u'}{size}")
        if cls == 1:
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        raise ValueError(f"HDF5 datatype class {cls} is not read")

    def dataset(self, header) -> np.ndarray:
        shape = dtype = raw = None
        for mtype, pos, _ in self.messages(header):
            if mtype == 0x01:
                version, rank = self.d[pos], self.d[pos + 1]
                first = pos + (8 if version == 1 else 4)
                shape = tuple(self.u64(first + 8 * i) for i in range(rank))
            elif mtype == 0x03:
                dtype = self.dtype(pos)
            elif mtype == 0x08:
                if self.d[pos] != 3:
                    raise ValueError(f"data layout version {self.d[pos]} is "
                                     f"not read (only 3)")
                layout = self.d[pos + 1]
                if layout == 0:
                    size = self.u(pos + 2, 2)
                    raw = self.d[pos + 4:pos + 4 + size]
                elif layout == 1:
                    start, size = self.u64(pos + 2), self.u64(pos + 10)
                    raw = (b"" if start == _UNDEF
                           else self.d[self.base + start:
                                       self.base + start + size])
                else:
                    raise ValueError("chunked HDF5 datasets are not read")
        if shape is None or dtype is None or raw is None:
            raise ValueError("a dataset lacks its dataspace, datatype or "
                             "layout")
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if len(raw) < n:
            if len(raw):
                raise ValueError("a dataset's storage is shorter than its "
                                 "shape")
            raw = bytes(n)          # never written: HDF5's fill value 0
        return np.frombuffer(raw[:n], dtype).reshape(shape).copy()


def read_columns(path: str) -> Dict[str, np.ndarray]:
    """name -> array of every dataset in the root group of ``path``."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    return {name: r.dataset(h) for name, h in r.group(r.root_header).items()}


# Symbol-table node entries are at most 2 * _LEAF_K, B-tree children at
# most 2 * _NODE_K (the superblock's "group leaf / internal node K", the
# HDF5 library's defaults).
_LEAF_K, _NODE_K = 4, 16


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages: List[bytes]) -> bytes:
    """A version 1 object header holding ``messages``."""
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype(dt: np.dtype) -> bytes:
    """The datatype message of a little-endian integer, float or
    fixed-length byte-string dtype."""
    size = dt.itemsize
    if dt.kind in "iu":
        signed = 0x08 if dt.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, signed, 0, 0, size, 0,
                           8 * size)
    if dt.kind == "f" and size in (4, 8):
        exp, mant, bias = (8, 23, 127) if size == 4 else (11, 52, 1023)
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0,
                           size, 0, 8 * size, mant, exp, 0, mant, bias)
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)  # null-padded
    raise ValueError(f"h5lite writes integer, float32/64 and byte-string "
                     f"columns, not {dt}")


def _column_header(shape, dt: np.dtype, addr: int, nbytes: int) -> bytes:
    space = struct.pack("<BBBx4x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)
    layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
    return _object_header([_message(0x01, space),
                           _message(0x03, _datatype(dt)),
                           _message(0x08, layout)])


def _little_endian(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind in "iuf" and a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return np.ascontiguousarray(a)


def write_columns(path: str,
                  columns: Iterable[Tuple[str, np.ndarray]]) -> str:
    """Write (name, array) pairs as the root group's datasets of a new
    HDF5 file at ``path``, which :func:`read_columns` and h5py read.  Each
    array is written before the next is taken from ``columns``.  Returns
    ``path``."""
    entries = {}
    with open(path, "wb") as f:
        f.write(bytes(96))                    # the superblock, written last
        for name, a in columns:
            if not name or "/" in name or "\0" in name:
                raise ValueError(f"bad column name {name!r}")
            if name in entries:
                raise ValueError(f"column {name!r} given twice")
            a = np.asarray(a)
            if a.ndim == 0:
                raise ValueError(f"column {name!r} is 0-d: h5lite writes "
                                 f"arrays of one or more dimensions")
            a = _little_endian(a)
            _datatype(a.dtype)                # refuse before writing
            f.write(bytes(-f.tell() % 8))
            addr = f.tell()
            f.write(a.tobytes())
            f.flush()
            entries[name] = (a.shape, a.dtype, addr, a.nbytes)
            del a
        if not entries:
            raise ValueError("no columns to write")
        f.write(bytes(-f.tell() % 8))
        names = sorted(entries, key=str.encode)   # the library's strcmp

        # the columns' object headers
        headers = {}
        for name in names:
            headers[name] = f.tell()
            f.write(_column_header(*entries[name]))

        # the local heap of the names: offset 0 holds the empty name
        heap_data, offsets = bytearray(8), {}
        for name in names:
            offsets[name] = len(heap_data)
            heap_data += _pad8(name.encode() + b"\0")
        heap = f.tell()
        # free list offset 1: none (the library's end-of-list mark)
        f.write(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                      heap + 32))
        f.write(heap_data)

        # symbol-table nodes of at most 2 * _LEAF_K names, in name order
        per = 2 * _LEAF_K
        groups = [names[i:i + per] for i in range(0, len(names), per)]
        if len(groups) > 2 * _NODE_K:
            raise ValueError(f"h5lite writes at most {2 * _NODE_K * per} "
                             f"columns")
        snods = []
        for grp in groups:
            snods.append(f.tell())
            node = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(grp)))
            for name in grp:
                node += struct.pack("<QQI4x16x", offsets[name],
                                    headers[name], 0)
            node += bytes(8 + 40 * per - len(node))
            f.write(node)

        # one B-tree leaf over them: key 0 the empty name, key i + 1 the
        # last name of node i
        btree = f.tell()
        node = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods),
                                               _UNDEF, _UNDEF))
        node += struct.pack("<Q", 0)
        for grp, child in zip(groups, snods):
            node += struct.pack("<QQ", child, offsets[grp[-1]])
        node += bytes(24 + 8 * (2 * _NODE_K + 1) + 8 * 2 * _NODE_K
                      - len(node))
        f.write(node)

        root = f.tell()
        f.write(_object_header([_message(0x11, struct.pack(
            "<QQ", btree, heap))]))
        eof = f.tell()
        f.seek(0)
        f.write(_SIGNATURE + struct.pack(
            "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _NODE_K, 0))
        f.write(struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF))
        f.write(struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
    return path
