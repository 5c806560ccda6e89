"""The port's reader and writer of the contract's HDF5 files, in numpy and
the standard library.

The JAX package reads the contract file (``box``, ``confmaps``,
``points_3D``, ``cropZone``, ``cameras_dlt_array``) through ``h5py``; the
port's machines need not have it, so this module reads what the contract's
known producers write, ``h5py`` at its default settings (JAX's
``write_synthetic_h5``, the lab's own files) and this module's writer, by
the HDF5 file format specification (version 3.0):

* superblock version 0, at the start of the file or after a user block of
  512, 1024, 2048, ... bytes;
* version-1 object headers, continuation blocks followed;
* a root group held by a symbol table (a version-1 B-tree over symbol-table
  nodes, names in a local heap);
* fixed-point (1 to 8 bytes, signed or not) and IEEE floats (4 or 8 bytes)
  in either byte order, returned as ``h5py`` returns them: an array in the
  file's byte order, a 0-d dataset in native order (``h5py`` gives a numpy
  scalar);
* contiguous layouts (one ``np.fromfile``) and chunked layouts indexed by a
  version-1 B-tree, deflated or not (a chunk's filter mask may skip
  deflate), edge chunks cropped to the extent.

MATLAB's ``-v7.3`` exports use this same format with a 512-byte user block
(column-major arrays come back in ``h5py``'s reversed shape, for the loader
to canonicalise); no real MATLAB export has been read by the tests.

Anything else raises ``ValueError`` naming the feature and the dataset:
superblocks 1 to 3 (``h5py``'s ``libver="v108"`` and later, with their
version-2 headers, link messages and chunk indexes), compact layouts,
storage or chunks never written, filters other than deflate (shuffle,
fletcher32, lzf, szip, blosc, ...), non-numeric types, shared messages and
datasets below the root group. Nothing falls back to ``h5py`` and nothing
is read in part.

:func:`write_datasets` writes root-level contiguous numeric datasets as
``h5py``'s defaults write them (superblock 0, a symbol-table root group,
version-1 object headers), for ``data/synthetic.py``.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import BinaryIO, Iterator, Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types (specification IV.A.2)
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _FILTERS = 0x1, 0x3, 0x5, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11

_DEFLATE = 1
_FILTER_NAMES = {2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_TYPE_CLASSES = ("fixed-point", "floating-point", "time", "string", "bitfield", "opaque",
                 "compound", "reference", "enumerated", "variable-length", "array")
# the IEEE layouts: (bit offset, precision, exponent location and size,
# mantissa location and size, exponent bias)
_IEEE = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}


def _superblock_offset(f: BinaryIO) -> int | None:
    """Where the superblock starts: 0, or after a user block of 512, 1024,
    2048, ... bytes."""
    size = os.fstat(f.fileno()).st_size
    offset = 0
    while offset + len(SIGNATURE) <= size:
        f.seek(offset)
        if f.read(len(SIGNATURE)) == SIGNATURE:
            return offset
        offset = 512 if offset == 0 else 2 * offset
    return None


class _Cursor:
    """Little-endian fields read in order from one block of metadata."""

    def __init__(self, data: bytes, pos: int, sizeof_addr: int, sizeof_len: int):
        self.data, self.pos = data, pos
        self.sizeof_addr, self.sizeof_len = sizeof_addr, sizeof_len

    def uint(self, n: int) -> int:
        if self.pos + n > len(self.data):
            raise ValueError("a metadata block ends early")
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def addr(self) -> int:
        return self.uint(self.sizeof_addr)

    def length(self) -> int:
        return self.uint(self.sizeof_len)


class _Reader:
    """One open file: its superblock, root group links and datasets."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.size = os.fstat(f.fileno()).st_size
        start = _superblock_offset(f)
        if start is None:
            raise ValueError("not an HDF5 file (no signature)")
        head = self.read_abs(start, 16)
        if head[8] != 0:
            raise ValueError(f"superblock version {head[8]} is not read (only version 0,"
                             " h5py's default)")
        self.sizeof_addr, self.sizeof_len = head[13], head[14]
        if self.sizeof_addr not in (2, 4, 8) or self.sizeof_len not in (2, 4, 8):
            raise ValueError(f"{self.sizeof_addr}-byte addresses or"
                             f" {self.sizeof_len}-byte lengths")
        c = self._cursor(self.read_abs(start, 48 + 6 * self.sizeof_addr), 24)
        self.base = c.addr()
        c.pos += 3 * self.sizeof_addr  # free space, end of file, driver info
        c.addr()  # the root entry's link name offset
        self.root = c.addr()
        self.undefined = (1 << (8 * self.sizeof_addr)) - 1

    # -- bytes -------------------------------------------------------------
    def _cursor(self, data: bytes, pos: int = 0) -> _Cursor:
        return _Cursor(data, pos, self.sizeof_addr, self.sizeof_len)

    def read_abs(self, offset: int, n: int) -> bytes:
        if n < 0 or offset + n > self.size:
            raise ValueError(f"{n} bytes at {offset} run past the end of the file"
                             f" ({self.size} bytes)")
        self.f.seek(offset)
        return self.f.read(n)

    def read(self, addr: int, n: int) -> bytes:
        """``n`` bytes at file address ``addr`` (relative to the base)."""
        return self.read_abs(self.base + addr, n)

    # -- object headers ----------------------------------------------------
    def messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        """(type, flags, body) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        head = self.read(addr, 16)
        if head[0] != 1:
            raise ValueError(f"the object header at {addr} is not version 1")
        (size,) = struct.unpack_from("<I", head, 8)
        blocks, out = [(addr + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            data, pos = self.read(start, length), 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    c = self._cursor(body)
                    blocks.append((c.addr(), c.length()))
                elif mtype:
                    out.append((mtype, mflags, body))
        return out

    # -- the root group ----------------------------------------------------
    def root_links(self) -> dict[str, int | str]:
        """Name -> object header address of every link of the root group;
        a soft link maps to a string naming its kind."""
        for mtype, _, body in self.messages(self.root):
            if mtype == _SYMBOL_TABLE:
                c = self._cursor(body)
                return self._symbol_table(c.addr(), c.addr())
        raise ValueError("the root group has no symbol table")

    def _symbol_table(self, btree: int, heap: int) -> dict[str, int | str]:
        head = self.read(heap, 8 + 2 * self.sizeof_len + self.sizeof_addr)
        if head[:4] != b"HEAP":
            raise ValueError("the root group's local heap lacks its signature")
        c = self._cursor(head, 8)
        seg_size = c.length()
        c.length()  # free list
        names = self.read(c.addr(), seg_size)
        entry = 2 * self.sizeof_addr + 24
        links: dict[str, int | str] = {}
        for node, _ in self._btree1(btree, 0, self.sizeof_len):
            head = self.read(node, 8)
            if head[:4] != b"SNOD":
                raise ValueError("a symbol table node lacks its signature")
            (n,) = struct.unpack_from("<H", head, 6)
            c = self._cursor(self.read(node + 8, n * entry))
            for _ in range(n):
                offset, header, cache = c.addr(), c.addr(), c.uint(4)
                c.pos += 20  # reserved, scratch pad
                name = names[offset:names.index(b"\0", offset)].decode("utf-8")
                links[name] = "a soft link" if cache == 2 else header
        return links

    def _btree1(self, addr: int, node_type: int, key_size: int) -> Iterator[tuple[int, bytes]]:
        """(child address, left key) of every leaf entry of the version-1
        B-tree at ``addr``, in key order."""
        head = self.read(addr, 8)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"a version-1 B-tree node at {addr} is not of type {node_type}")
        level, entries = head[5], struct.unpack_from("<H", head, 6)[0]
        stride = key_size + self.sizeof_addr
        c = self._cursor(self.read(addr + 8 + 2 * self.sizeof_addr, entries * stride + key_size))
        for i in range(entries):
            c.pos = i * stride + key_size
            key, child = c.data[i * stride:c.pos], c.addr()
            if level:
                yield from self._btree1(child, node_type, key_size)
            else:
                yield child, key

    # -- datasets ----------------------------------------------------------
    def dataset(self, addr: int) -> np.ndarray:
        msgs: dict[int, bytes] = {}
        for mtype, mflags, body in self.messages(addr):
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                if mflags & 0x02:
                    raise ValueError(f"a shared message (type {mtype}) is not read")
                msgs.setdefault(mtype, body)
        if _LAYOUT not in msgs:
            raise ValueError("the object has no data layout message: a group, not a dataset")
        shape = self._dataspace(msgs[_DATASPACE])
        dtype = _datatype(msgs[_DATATYPE])
        deflated = _deflated(msgs[_FILTERS]) if _FILTERS in msgs else False
        layout = self._cursor(msgs[_LAYOUT])
        version, cls = layout.uint(1), layout.uint(1)
        if version != 3:
            raise ValueError(f"data layout message version {version} is not read")
        count = math.prod(shape)
        if cls == 1:
            start, size = layout.addr(), layout.length()
            if count == 0:
                return np.zeros(shape, dtype)
            if start == self.undefined:
                raise ValueError("storage never written (a dataset created but not"
                                 " written) is not read")
            if size != count * dtype.itemsize:
                raise ValueError(f"contiguous storage of {size} bytes for {count} elements")
            if self.base + start + size > self.size:
                raise ValueError("contiguous storage runs past the end of the file")
            self.f.seek(self.base + start)
            return np.fromfile(self.f, dtype, count).reshape(shape)
        if cls == 2:
            return self._chunked(layout, shape, dtype, deflated)
        raise ValueError(f"the {({0: 'compact', 3: 'virtual'}).get(cls, cls)} layout"
                         " is not read")

    def _dataspace(self, body: bytes) -> tuple[int, ...]:
        c = self._cursor(body)
        version, rank = c.uint(1), c.uint(1)
        if version != 1:
            raise ValueError(f"dataspace message version {version} is not read")
        c.pos = 8
        return tuple(c.length() for _ in range(rank))

    def _chunked(self, layout: _Cursor, shape, dtype, deflated: bool) -> np.ndarray:
        """Each chunk of the version-1 B-tree into its place; every chunk
        that meets the extent must have been written. A key holds the
        stored size, the filter mask and the chunk's offset in elements
        (plus a zero for the element size)."""
        ndims = layout.uint(1)
        index = layout.addr()
        dims = [layout.uint(4) for _ in range(ndims)]
        chunk = tuple(dims[:-1])
        if len(chunk) != len(shape) or dims[-1] != dtype.itemsize:
            raise ValueError(f"chunk dimensions {dims} for shape {shape} and {dtype}")
        nbytes = math.prod(chunk) * dtype.itemsize
        out = np.empty(shape, dtype)
        placed = 0
        leaves = self._btree1(index, 1, 8 + 8 * ndims) if index != self.undefined else ()
        for child, key in leaves:
            size, mask = struct.unpack_from("<II", key)
            offset = struct.unpack_from(f"<{ndims}Q", key, 8)
            if offset[-1]:
                raise ValueError("a chunk key with an element offset")
            offset = offset[:-1]
            if any(o >= s for o, s in zip(offset, shape)):
                continue  # past the extent
            raw = self.read(child, size)
            if deflated and not mask & 1:
                raw = zlib.decompress(raw)
            if len(raw) != nbytes:
                raise ValueError(f"a chunk of {len(raw)} bytes, not {nbytes}")
            block = np.frombuffer(raw, dtype).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
            placed += 1
        if placed != math.prod(-(-s // c) for s, c in zip(shape, chunk)):
            raise ValueError("chunks never written (storage not allocated) are not read")
        return out


def _datatype(body: bytes) -> np.dtype:
    cls = body[0] & 0x0F
    bits = body[1] | body[2] << 8 | body[3] << 16
    (size,) = struct.unpack_from("<I", body, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"a {precision}-bit integer in {size} bytes is not read")
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        if size not in _IEEE:
            raise ValueError(f"a {size}-byte float is not read (only 4- and 8-byte IEEE floats)")
        layout = struct.unpack_from("<HHBBBBI", body, 8)
        if (bits & 0x40 or layout != _IEEE[size] or (bits >> 4) & 3 != 2
                or (bits >> 8) & 0xFF != 8 * size - 1):
            raise ValueError(f"a {size}-byte float that is not IEEE is not read")
        return np.dtype(f"{order}f{size}")
    name = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else f"class {cls}"
    raise ValueError(f"the {name} datatype is not read (only integers and IEEE floats)")


def _deflated(body: bytes) -> bool:
    """Whether a version-1 filter pipeline is deflate alone (or empty);
    any other filter is refused."""
    version, n = body[0], body[1]
    if version != 1:
        raise ValueError(f"filter pipeline message version {version} is not read")
    fids = []
    pos = 8
    for _ in range(n):
        fid, name_len, _, nvals = struct.unpack_from("<HHHH", body, pos)
        pos += 8 + -(-name_len // 8) * 8 + 4 * (nvals + nvals % 2)
        fids.append(fid)
    for fid in fids:
        if fid != _DEFLATE:
            raise ValueError(f"the {_FILTER_NAMES.get(fid, f'id {fid}')} filter is not read"
                             " (only deflate)")
    return bool(fids)


def read_datasets(path: str, names) -> dict[str, np.ndarray]:
    """The root-level datasets ``names`` of the HDF5 file at ``path``, each
    equal bit for bit to ``h5py.File(path)[name][()]`` (dtype and shape
    too). A missing name raises ``KeyError``; a file, layout or type this
    module does not read raises ``ValueError`` naming it."""
    names = list(names)
    for name in names:
        if "/" in name:
            raise ValueError(f"{path}: dataset {name!r}: only datasets of the root group"
                             " are read")
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        try:
            reader = _Reader(f)
            links = reader.root_links()
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        for name in names:
            if name not in links:
                raise KeyError(f"{path}: no dataset {name!r} in the root group")
            target = links[name]
            try:
                if isinstance(target, str):
                    raise ValueError(f"{target} is not followed")
                data = reader.dataset(target)
                out[name] = data if data.ndim else data.astype(data.dtype.newbyteorder("="))
            except ValueError as e:
                raise ValueError(f"{path}: dataset {name!r}: {e}") from None
    return out
# -- the writer ----------------------------------------------------------------
_UNDEFINED = (1 << 64) - 1  # an address never written, with 8-byte addresses
_LEAF_K, _INTERNAL_K = 4, 16  # the superblock's group K values, h5py's defaults
_BTREE_NODE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
_SNOD_ENTRY = 40


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    big = dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian)
    if dtype.kind in "iu":
        bits = (1 if big else 0) | (0x08 if dtype.kind == "i" else 0)
        props = struct.pack("<HH", 0, 8 * dtype.itemsize)
        cls = 0
    else:
        bits = (1 if big else 0) | 0x20 | (8 * dtype.itemsize - 1) << 8  # implied MSB
        props = struct.pack("<HHBBBBI", *_IEEE[dtype.itemsize])
        cls = 1
    return struct.pack("<B3BI", 0x10 | cls, bits & 0xFF, bits >> 8 & 0xFF, bits >> 16,
                       dtype.itemsize) + props


def _dataset_header(array: np.ndarray, data_addr: int) -> bytes:
    rank = array.ndim
    dims = struct.pack(f"<{rank}Q", *array.shape)
    space = struct.pack("<BBB5x", 1, rank, 1 if rank else 0) + (dims + dims if rank else b"")
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # late allocation, default (zero) fill
    layout = struct.pack("<BBQQ", 3, 1, data_addr, array.nbytes)
    return _object_header([
        _message(_DATASPACE, space),
        _message(_DATATYPE, _datatype_message(array.dtype), flags=1),
        _message(_FILL, fill, flags=1),
        _message(_LAYOUT, layout),
    ])


def write_datasets(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Write ``arrays`` as root-level contiguous datasets of a new HDF5 file
    at ``path``, laid out as ``h5py``'s defaults lay them out: superblock
    version 0 with 8-byte addresses, a root group held by a symbol table (a
    version-1 B-tree over symbol-table nodes of at most eight names, names
    in a local heap), version-1 object headers. Numeric dtypes only (1- to
    8-byte integers, 4- and 8-byte floats); ``h5py`` reads the file back
    bit for bit."""
    items = [(name, np.asarray(arrays[name])) for name in sorted(arrays)]
    for name, a in items:
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"dataset name {name!r}: root-level names only")
        if not (a.dtype.kind in "iu" and a.dtype.itemsize in (1, 2, 4, 8)
                or a.dtype.kind == "f" and a.dtype.itemsize in _IEEE):
            raise ValueError(f"dataset {name!r}: dtype {a.dtype} is not written")
    nodes = [items[i:i + 2 * _LEAF_K] for i in range(0, len(items), 2 * _LEAF_K)]
    if len(nodes) > 2 * _INTERNAL_K:
        raise ValueError(f"{len(items)} datasets: at most {2 * _INTERNAL_K * 2 * _LEAF_K}")

    # the local heap: "" at 0 (the root's own name), then each name, 8-aligned
    heap_data, name_offset = bytearray(8), {}
    for name, _ in items:
        name_offset[name] = len(heap_data)
        raw = name.encode("utf-8") + b"\0"
        heap_data += raw + b"\0" * (-len(raw) % 8)

    superblock_size, root_size = 96, 16 + 24
    btree_addr = superblock_size + root_size
    heap_addr = btree_addr + _BTREE_NODE
    heap_data_addr = heap_addr + 32
    snod_addr = heap_data_addr + len(heap_data)
    snod_size = 8 + 2 * _LEAF_K * _SNOD_ENTRY
    cursor = snod_addr + len(nodes) * snod_size
    header_of = {}  # each dataset's object header, then its data, in name order
    for name, a in items:
        header_of[name] = cursor
        cursor += len(_dataset_header(a, 0))
    data_of = {}
    for name, a in items:
        data_of[name] = cursor if a.nbytes else _UNDEFINED
        cursor += a.nbytes

    sb = SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
    sb += struct.pack("<QQQQ", 0, _UNDEFINED, cursor, _UNDEFINED)
    sb += struct.pack("<QQII", 0, superblock_size, 1, 0) + struct.pack("<QQ", btree_addr, heap_addr)
    root = _object_header([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap_addr))])

    # one B-tree leaf over the symbol-table nodes; key i bounds the names
    # of node i - 1 from above (key 0 is the empty name)
    btree = b"TREE" + struct.pack("<BBHQQQ", 0, 0, len(nodes), _UNDEFINED, _UNDEFINED, 0)
    for i, node in enumerate(nodes):
        btree += struct.pack("<QQ", snod_addr + i * snod_size, name_offset[node[-1][0]])
    btree = btree.ljust(_BTREE_NODE, b"\0")
    heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, heap_data_addr)
    snods = bytearray()
    for node in nodes:
        block = b"SNOD" + struct.pack("<BBH", 1, 0, len(node))
        for name, _ in node:
            block += struct.pack("<QQII16x", name_offset[name], header_of[name], 0, 0)
        snods += block.ljust(snod_size, b"\0")

    with open(path, "wb") as f:
        f.write(sb + root + btree + heap + bytes(heap_data) + bytes(snods))
        for name, a in items:
            f.write(_dataset_header(a, data_of[name]))
        for _, a in items:
            np.ascontiguousarray(a).tofile(f)  # C order: the transposed dialect too
    return path
