"""Flat HDF5 files of named arrays, read without h5py.

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
"""
from __future__ import annotations

from typing import Dict

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
