"""HDF5 files of the reference's label and LDA layout, with or without h5py.

The reference keeps its caption labels and LDA vectors in HDF5 files whose
root group holds plain numeric datasets (``labels``, ``label_start_ix``,
``label_end_ix``; one vector a video id).  ``open_h5`` returns an
``h5py.File`` where h5py is installed, and otherwise this module's ``File``:
a reader and writer of that subset of the format (HDF5 1.8's "earliest"
layout, which h5py writes by default):

  * superblock version 0 or 1, 8-byte offsets and lengths;
  * the root group as a symbol table (v1 B-tree, local heap, symbol nodes);
  * datasets with a version-1 object header (continuation blocks read),
    dataspace version 1 or 2, fixed-point or IEEE floating-point types of
    either byte order, contiguous storage, no filters.

Anything else (superblock 2-3, version-2 object headers, compact, chunked
or filtered storage, nested groups) raises NotImplementedError naming h5py.
The writer lays one group out in a single symbol node (its leaf K sized to
the entry count) and writes every dataset contiguously; h5py reads the
result, and ``tests/test_torch_datatools.py`` holds both directions.
"""
from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_FREE_NULL = 1  # the local heap's end of free list on disk (HDF5's H5HL_FREE_NULL)
_INTERNAL_K = 16
_MSG_DATASPACE, _MSG_DATATYPE, _MSG_LAYOUT = 0x0001, 0x0003, 0x0008
_MSG_FILTERS, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x000B, 0x0010, 0x0011


def open_h5(path: str, mode: str = "r"):
    """``h5py.File(path, mode)`` where h5py is installed, else ``File``."""
    try:
        import h5py
    except ImportError:
        return File(path, mode)
    return h5py.File(path, mode)


def _unsupported(path: str, what: str):
    return NotImplementedError(
        f"{path}: {what} is outside the HDF5 subset echr_tpu_torch.data.hdf5 reads; "
        "install h5py to read this file")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class File:
    """A root group of numeric datasets: mode "r" reads a file, mode "w"
    collects ``file[name] = array`` and writes the file at ``close``.
    ``file[name]`` returns the dataset as a numpy array."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: File reads ('r') or writes ('w') a whole file")
        self.path, self.mode = str(path), mode
        self._new: Dict[str, np.ndarray] = {}
        self._index: Dict[str, int] = {}  # name -> object header address
        if mode == "r":
            with open(self.path, "rb") as f:
                self._buf = f.read()
            self._index = self._read_root()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()

    def keys(self) -> List[str]:
        return sorted(self._new if self.mode == "w" else self._index)

    def __contains__(self, name: str) -> bool:
        return name in (self._new if self.mode == "w" else self._index)

    def __getitem__(self, name: str) -> np.ndarray:
        if self.mode == "w":
            return self._new[name]
        if name not in self._index:
            raise KeyError(f"{self.path}: no dataset {name!r}")
        return self._read_dataset(name, self._index[name])

    def __setitem__(self, name: str, value) -> None:
        if self.mode != "w":
            raise ValueError(f"{self.path} is open for reading")
        if not name or "/" in name or name in self._new:
            raise ValueError(f"dataset name {name!r}: one new name in the root group")
        arr = np.ascontiguousarray(value)
        if arr.dtype.kind not in "iuf":
            raise TypeError(f"{name}: dtype {arr.dtype} is not a fixed-point or float type")
        self._new[name] = arr

    def close(self) -> None:
        if self.mode == "w" and self._new is not None:
            data = _write(self._new)
            with open(self.path, "wb") as f:
                f.write(data)
            self._new = None

    # ------------------------------------------------------------ reading

    def _u(self, fmt: str, at: int):
        return struct.unpack_from("<" + fmt, self._buf, at)

    def _read_root(self) -> Dict[str, int]:
        b = self._buf
        base = b.find(_SIG)
        if base != 0:
            raise _unsupported(self.path, "a user block or a missing signature")
        version = b[8]
        if version not in (0, 1):
            raise _unsupported(self.path, f"superblock version {version}")
        if (b[13], b[14]) != (8, 8):
            raise _unsupported(self.path, "offsets or lengths other than 8 bytes")
        # root symbol table entry after the fixed fields (+4 in version 1)
        ste = 56 + (4 if version == 1 else 0)
        header = self._u("Q", ste + 8)[0]
        btree, heap = self._symbol_table(header, ste)
        return self._group_entries(btree, heap)

    def _symbol_table(self, header: int, ste: int):
        cache_type = self._u("I", ste + 16)[0]
        if cache_type == 1:
            return self._u("QQ", ste + 24)
        for mtype, at, _ in self._messages(header):
            if mtype == _MSG_SYMBOL_TABLE:
                return self._u("QQ", at)
        raise _unsupported(self.path, "a root group without a symbol table (link messages)")

    def _heap_name(self, data_addr: int, offset: int) -> str:
        start = data_addr + offset
        return self._buf[start:self._buf.index(b"\0", start)].decode("utf-8")

    def _group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        b = self._buf
        if b[heap:heap + 4] != b"HEAP":
            raise _unsupported(self.path, "a damaged local heap")
        heap_data = self._u("Q", heap + 24)[0]
        out: Dict[str, int] = {}
        stack = [btree]
        while stack:
            node = stack.pop()
            if b[node:node + 4] != b"TREE" or b[node + 4] != 0:
                raise _unsupported(self.path, "a group B-tree node")
            level, used = b[node + 5], self._u("H", node + 6)[0]
            children = [self._u("Q", node + 24 + 8 + 16 * i)[0] for i in range(used)]
            if level > 0:
                stack.extend(children)
                continue
            for snod in children:
                if b[snod:snod + 4] != b"SNOD":
                    raise _unsupported(self.path, "a damaged symbol table node")
                for i in range(self._u("H", snod + 6)[0]):
                    e = snod + 8 + 40 * i
                    name_off, addr = self._u("QQ", e)
                    if self._u("I", e + 16)[0] == 1:
                        raise _unsupported(self.path, "a nested group")
                    out[self._heap_name(heap_data, name_off)] = addr
        return out

    def _messages(self, header: int):
        """(type, data address, size) of every message of a version-1
        object header, continuation blocks followed."""
        b = self._buf
        if b[header] != 1:
            raise _unsupported(self.path, f"object header version {b[header]}")
        n_msgs = self._u("H", header + 2)[0]
        blocks = [(header + 16, self._u("I", header + 8)[0])]
        seen = 0
        while blocks and seen < n_msgs:
            at, size = blocks.pop(0)
            end = at + size
            while at + 8 <= end and seen < n_msgs:
                mtype, msize = self._u("HH", at)
                seen += 1
                if mtype == _MSG_CONTINUATION:
                    blocks.append(self._u("QQ", at + 8))
                elif mtype:
                    yield mtype, at + 8, msize
                at += 8 + msize

    def _read_dataset(self, name: str, header: int) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, at, size in self._messages(header):
            if mtype == _MSG_DATASPACE:
                shape = self._dataspace(at)
            elif mtype == _MSG_DATATYPE:
                dtype = self._datatype(at, name)
            elif mtype == _MSG_LAYOUT:
                layout = at
            elif mtype == _MSG_FILTERS:
                raise _unsupported(self.path, f"{name}: a filter pipeline")
        if shape is None or dtype is None or layout is None:
            raise _unsupported(self.path, f"{name}: an object without dataspace, type and "
                                          "layout (not a dataset)")
        version, cls = self._buf[layout], self._buf[layout + 1]
        if version != 3:
            raise _unsupported(self.path, f"{name}: layout message version {version}")
        if cls != 1:
            raise _unsupported(self.path, f"{name}: {'compact' if cls == 0 else 'chunked'} "
                                          "storage")
        n = int(np.prod(shape, dtype=np.int64))
        start = self._u("Q", layout + 2)[0]
        if n and start == _UNDEF:
            raise _unsupported(self.path, f"{name}: unallocated storage")
        return np.frombuffer(self._buf, dtype=dtype, count=n, offset=start if n else 0
                             ).reshape(shape).astype(dtype.newbyteorder("="))

    def _dataspace(self, at: int):
        version, ndims = self._buf[at], self._buf[at + 1]
        if version == 1:
            dims_at = at + 8
        elif version == 2:
            if self._buf[at + 3] == 2:  # a null dataspace
                return (0,)
            dims_at = at + 4
        else:
            raise _unsupported(self.path, f"dataspace version {version}")
        return tuple(int(x) for x in self._u(f"{ndims}Q", dims_at)) if ndims else ()

    def _datatype(self, at: int, name: str) -> np.dtype:
        cls, bits0 = self._buf[at] & 0x0F, self._buf[at + 1]
        size = self._u("I", at + 4)[0]
        order = ">" if bits0 & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits0 & 0x08 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8):
            return np.dtype(f"{order}f{size}")
        raise _unsupported(self.path, f"{name}: datatype class {cls} of {size} bytes")


# ---------------------------------------------------------------- writing


def _message(mtype: int, data: bytes) -> bytes:
    return struct.pack("<HHB3x", mtype, _pad8(len(data)), 0) + data.ljust(_pad8(len(data)),
                                                                          b"\0")


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, size, 0,
                           8 * size)
    exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[size]
    return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size, mant,
                       exp, 0, mant, bias)


def _write(datasets: Dict[str, np.ndarray]) -> bytes:
    names = sorted(datasets)
    leaf_k = max(4, (len(names) + 1) // 2)
    # the local heap: "" at offset 0, the names, then one free block
    heap_data = bytearray(8)
    name_off = {}
    for n in names:
        name_off[n] = len(heap_data)
        raw = n.encode("utf-8") + b"\0"
        heap_data += raw.ljust(_pad8(len(raw)), b"\0")
    free_at = len(heap_data)
    heap_data += struct.pack("<QQ", _FREE_NULL, 16)

    root_header = _object_header([_message(_MSG_SYMBOL_TABLE, bytes(16))])
    sizes = {"super": 96, "root": len(root_header), "heap": 32, "heap_data": len(heap_data),
             "btree": 24 + 16 * _INTERNAL_K + 8 * (2 * _INTERNAL_K + 1),
             "snod": 8 + 40 * 2 * leaf_k}
    addr, at = {}, 0
    for k in ("super", "root", "heap", "heap_data", "btree", "snod"):
        addr[k] = at
        at += _pad8(sizes[k])
    headers, data_at = {}, {}
    for n in names:
        arr = datasets[n].astype(datasets[n].dtype.newbyteorder("<"), copy=False)
        datasets[n] = arr
        headers[n] = at  # placeholder sizes are fixed: written below
        at += _pad8(len(_dataset_header(arr, 0)))
    for n in names:
        data_at[n] = at if datasets[n].size else _UNDEF
        at += _pad8(datasets[n].nbytes)
    eof = at

    out = bytearray(eof)

    def put(where: int, blob: bytes) -> None:
        out[where:where + len(blob)] = blob

    root_ste = struct.pack("<QQII", 0, addr["root"], 1, 0) + struct.pack(
        "<QQ", addr["btree"], addr["heap"])
    put(0, _SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack(
        "<HHIQQQQ", leaf_k, _INTERNAL_K, 0, 0, _UNDEF, eof, _UNDEF) + root_ste)
    put(addr["root"], _object_header([_message(_MSG_SYMBOL_TABLE, struct.pack(
        "<QQ", addr["btree"], addr["heap"]))]))
    put(addr["heap"], b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
        "<QQQ", len(heap_data), free_at, addr["heap_data"]))
    put(addr["heap_data"], bytes(heap_data))
    last = name_off[names[-1]] if names else 0
    used = 1 if names else 0
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, used, _UNDEF, _UNDEF)
    if names:
        btree += struct.pack("<QQQ", 0, addr["snod"], last)
    put(addr["btree"], btree)
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
        struct.pack("<QQII16x", name_off[n], headers[n], 0, 0) for n in names)
    put(addr["snod"], snod)
    for n in names:
        arr = datasets[n]
        put(headers[n], _dataset_header(arr, data_at[n]))
        if arr.size:
            put(data_at[n], arr.tobytes())
    return bytes(out)


def _dataset_header(arr: np.ndarray, data_addr: int) -> bytes:
    space = struct.pack("<BBBx4x", 1, arr.ndim, 0) + b"".join(
        struct.pack("<Q", d) for d in arr.shape)
    layout = struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)
    return _object_header([_message(_MSG_DATASPACE, space),
                           _message(_MSG_DATATYPE, _datatype_message(arr.dtype)),
                           _message(_MSG_LAYOUT, layout)])
