"""The port's reader and writer of HDF5 files, in numpy and the standard
library: the contract's data files and keras ``.h5`` saves.

The JAX package reads the contract file (``box``, ``confmaps``,
``points_3D``, ``cropZone``, ``cameras_dlt_array``) and keras saves
(``importers.py``) through ``h5py``; the port's machines need not have it,
so this module reads what their known producers write, ``h5py`` at its
default settings (JAX's ``write_synthetic_h5``, the lab's own files, keras'
``model.save``) and this module's writer, by the HDF5 file format
specification (version 3.0):

* superblock version 0, at the start of the file or after a user block of
  512, 1024, 2048, ... bytes;
* version-1 object headers, continuation blocks followed;
* groups held by symbol tables (a version-1 B-tree over symbol-table nodes,
  names in a local heap), at any depth, walked by path (:class:`File`,
  :class:`Group`);
* fixed-point (1 to 8 bytes, signed or not) and IEEE floats (4 or 8 bytes)
  in either byte order, returned as ``h5py`` returns them: an array in the
  file's byte order, a 0-d dataset in native order (``h5py`` gives a numpy
  scalar);
* contiguous layouts (one ``np.fromfile``) and chunked layouts indexed by a
  version-1 B-tree, deflated or not (a chunk's filter mask may skip
  deflate), edge chunks cropped to the extent;
* version-1 attribute messages of those numeric types, of fixed-length
  strings (a numpy ``S`` array) and of variable-length strings held in
  global heap collections (``str``, in an object array unless scalar),
  each as ``h5py``'s ``attrs[name]`` returns it.

MATLAB's ``-v7.3`` exports use this same format with a 512-byte user block
(column-major arrays come back in ``h5py``'s reversed shape, for the loader
to canonicalise); no real MATLAB export has been read by the tests.

Anything else raises ``ValueError`` naming the feature (and the dataset or
attribute): superblocks 1 to 3 (``h5py``'s ``libver="v108"`` and later),
version-2 object headers (``track_order=True`` groups too), link messages
(compact or dense link storage), dense attribute storage, attribute
messages of versions 2 and 3, compact layouts, storage or chunks never
written, filters other than deflate (shuffle, fletcher32, lzf, szip, blosc,
...), other datatypes (compound, enumerated, variable-length sequences,
...), shared messages and soft links. Nothing falls back to ``h5py`` and
nothing is read in part.

:func:`write_datasets` writes contiguous numeric datasets at any depth and
attributes on any group as ``h5py``'s defaults write them (superblock 0,
symbol-table groups, version-1 object headers and attribute messages), for
``data/synthetic.py`` and for keras-layout saves.
"""

from __future__ import annotations

import functools
import math
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterator, Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types (specification IV.A.2)
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK = 0x1, 0x2, 0x3, 0x5, 0x6
_LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0xC, 0x10, 0x11
_ATTRIBUTE_INFO = 0x15

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
    """One open file: its superblock, groups, attributes and datasets."""

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
        self._heaps: dict[int, dict[int, bytes]] = {}  # global heap collections read

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
        if head[:4] == b"OHDR":
            raise ValueError(f"the version-2 object header at {addr} (h5py's track_order=True,"
                             " libver v108 and later) is not read")
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

    # -- groups ------------------------------------------------------------
    def links(self, addr: int) -> dict[str, int | str]:
        """Name -> object header address of every link of the group at
        ``addr``, in name order (h5py's); a soft link maps to a string
        naming its kind."""
        for mtype, _, body in self.messages(addr):
            if mtype == _SYMBOL_TABLE:
                c = self._cursor(body)
                return self._symbol_table(c.addr(), c.addr())
            if mtype in (_LINK_INFO, _LINK):
                raise ValueError("link messages (compact or dense link storage) are not read")
        raise ValueError("the group has no symbol table")

    def is_group(self, addr: int) -> bool:
        """Whether the object at ``addr`` is a group (a symbol table, or
        link messages this reader refuses) rather than a dataset."""
        return any(t in (_SYMBOL_TABLE, _LINK_INFO, _LINK) for t, _, _ in self.messages(addr))

    def _symbol_table(self, btree: int, heap: int) -> dict[str, int | str]:
        head = self.read(heap, 8 + 2 * self.sizeof_len + self.sizeof_addr)
        if head[:4] != b"HEAP":
            raise ValueError("a group's local heap lacks its signature")
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

    # -- attributes --------------------------------------------------------
    def attributes(self, addr: int) -> dict[str, Any]:
        """Name -> value of every attribute of the object at ``addr``, in
        name order, each as ``h5py``'s ``attrs[name]`` returns it."""
        out = {}
        for mtype, mflags, body in self.messages(addr):
            if mtype == _ATTRIBUTE_INFO:
                raise ValueError("an attribute info message (dense attribute storage) is not read")
            if mtype == _ATTRIBUTE:
                if mflags & 0x02:
                    raise ValueError("a shared attribute message is not read")
                name, value = self._attribute(body)
                out[name] = value
        return dict(sorted(out.items()))

    def _attribute(self, body: bytes) -> tuple[str, Any]:
        """A version-1 attribute message: its name, then its datatype,
        dataspace and data, the first three each padded to 8 bytes."""
        name_size, type_size, space_size = struct.unpack_from("<HHH", body, 2)
        pos = 9 if body[0] == 3 else 8  # version 3 has a name encoding byte first
        name = body[pos:pos + name_size].split(b"\0")[0].decode("utf-8", "replace")
        if body[0] != 1:
            raise ValueError(f"attribute {name!r}: attribute message version {body[0]} is not"
                             " read (only version 1, h5py's default)")
        pos += _pad8(name_size)
        dtype = body[pos:pos + type_size]
        pos += _pad8(type_size)
        try:
            shape = self._dataspace(body[pos:pos + space_size])
            return name, self._attribute_value(dtype, shape, body[pos + _pad8(space_size):])
        except ValueError as e:
            raise ValueError(f"attribute {name!r}: {e}") from None

    def _attribute_value(self, dt: bytes, shape: tuple[int, ...], data: bytes) -> Any:
        """Fixed-length strings as a numpy ``S`` array, variable-length
        strings as ``str`` (in an object array unless scalar), numbers as
        their array; a scalar as a numpy scalar, as h5py gives them."""
        cls, count = dt[0] & 0x0F, math.prod(shape)
        if cls == 9:
            return self._vlen_strings(dt, shape, data)
        dtype = np.dtype(f"S{struct.unpack_from('<I', dt, 4)[0]}") if cls == 3 else _datatype(dt)
        if len(data) < count * dtype.itemsize:
            raise ValueError(f"{len(data)} bytes of data for {count} elements of {dtype}")
        a = np.frombuffer(data, dtype, count).reshape(shape).copy()
        return a if a.ndim else a[()]

    def _vlen_strings(self, dt: bytes, shape: tuple[int, ...], data: bytes) -> Any:
        """Each element a 4-byte length and a global heap ID (a collection's
        address and a 4-byte object index)."""
        if dt[1] & 0x0F != 1:
            raise ValueError("the variable-length sequence datatype is not read (only strings)")
        c = self._cursor(data)
        out = []
        for _ in range(math.prod(shape)):
            length, collection, index = c.uint(4), c.addr(), c.uint(4)
            raw = self._heap_object(collection, index)[:length] if length else b""
            out.append(raw.decode("utf-8", "surrogateescape"))
        if not shape:
            return out[0]
        a = np.empty(len(out), object)
        a[:] = out
        return a.reshape(shape)

    def _heap_object(self, addr: int, index: int) -> bytes:
        """Object ``index`` of the global heap collection at ``addr``: its
        objects follow the header, each an index, a reference count and a
        size, then its bytes padded to 8; index 0 is the free space."""
        if addr not in self._heaps:
            head = self.read(addr, 8 + self.sizeof_len)
            if head[:4] != b"GCOL":
                raise ValueError(f"the global heap collection at {addr} lacks its signature")
            size = self._cursor(head, 8).length()
            data, objects = self.read(addr, size), {}
            pos = step = 8 + self.sizeof_len
            while pos + step <= size:
                (i,) = struct.unpack_from("<H", data, pos)
                if i == 0:
                    break
                n = self._cursor(data, pos + 8).length()
                objects[i] = data[pos + step:pos + step + n]
                pos += step + _pad8(n)
            self._heaps[addr] = objects
        if index not in self._heaps[addr]:
            raise ValueError(f"no object {index} in the global heap collection at {addr}")
        return self._heaps[addr][index]

    # -- datasets ----------------------------------------------------------
    def dataset(self, addr: int) -> np.ndarray:
        msgs: dict[int, bytes] = {}
        for mtype, mflags, body in self.messages(addr):
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                if mflags & 0x02:
                    raise ValueError(f"a shared message (type {mtype}) is not read")
                msgs.setdefault(mtype, body)
        if _LAYOUT not in msgs:
            raise ValueError("the object has no data layout message (not a dataset)")
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


def _pad8(n: int) -> int:
    return n + -n % 8


class Dataset:
    """A dataset of an open :class:`File`: ``ds.attrs``, and its data from
    ``ds[()]`` or ``np.asarray(ds, dtype)``, read on each access (equal bit
    for bit to h5py's ``ds[()]``; a 0-d dataset as a 0-d array in native
    order)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader, self._addr, self.name = reader, addr, name

    @functools.cached_property
    def attrs(self) -> dict[str, Any]:
        return self._reader.attributes(self._addr)

    def __getitem__(self, key) -> np.ndarray:
        if key != ():
            raise ValueError(f"{self.name}: only ds[()] (the whole dataset) is read")
        data = self._reader.dataset(self._addr)
        return data if data.ndim else data.astype(data.dtype.newbyteorder("="))

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        data = self[()]
        return data if dtype is None else data.astype(dtype)


class Group:
    """A group of an open :class:`File`, with the part of ``h5py.Group``'s
    interface that a walk over a keras save uses: ``path in g``, ``g[path]``
    (a :class:`Group` or a :class:`Dataset`; a path walks group by group, a
    leading "/" from the root), ``g.keys()`` in h5py's order (name order)
    and ``g.attrs`` (a dict, each value as h5py's ``attrs[name]`` gives
    it)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._reader, self._addr, self.name = reader, addr, name

    @functools.cached_property
    def attrs(self) -> dict[str, Any]:
        return self._reader.attributes(self._addr)

    @functools.cached_property
    def _links(self) -> dict[str, int | str]:
        return self._reader.links(self._addr)

    def keys(self) -> list[str]:
        return list(self._links)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str) -> "Group | Dataset":
        node: Group | Dataset = self
        if path.startswith("/"):
            node = Group(self._reader, self._reader.root, "/")
        for part in filter(None, path.split("/")):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name!r} is a dataset, not a group")
            if part not in node._links:
                raise KeyError(f"no {part!r} in the group {node.name!r}")
            target, name = node._links[part], f"{node.name.rstrip('/')}/{part}"
            if isinstance(target, str):
                raise ValueError(f"{name!r}: {target} is not followed")
            node = (Group if self._reader.is_group(target) else Dataset)(self._reader, target,
                                                                          name)
        return node


class File(Group):
    """An HDF5 file opened for reading, as its root group (``with
    File(path) as f``). A file this module does not read raises
    ``ValueError`` naming the feature, here or when the part that holds it
    is read; nothing falls back to ``h5py``."""

    def __init__(self, path: str):
        self._file = open(path, "rb")
        try:
            reader = _Reader(self._file)
        except ValueError as e:
            self._file.close()
            raise ValueError(f"{path}: {e}") from None
        super().__init__(reader, reader.root, "/")

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def is_hdf5(path: str) -> bool:
    """Whether ``path`` is a file with the HDF5 signature at its start or
    after a user block of 512, 1024, 2048, ... bytes (as ``h5py.is_hdf5``
    finds it)."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return _superblock_offset(f) is not None


def read_datasets(path: str, names) -> dict[str, np.ndarray]:
    """The datasets ``names`` (paths from the root group: "box",
    "model_weights/dense/kernel:0") of the HDF5 file at ``path``, each equal
    bit for bit to ``h5py.File(path)[name][()]`` (dtype and shape too). A
    missing name raises ``KeyError``; a file, layout or type this module
    does not read raises ``ValueError`` naming it."""
    out: dict[str, np.ndarray] = {}
    with File(path) as f:
        for name in names:
            try:
                node = f[name]
                if isinstance(node, Group):
                    raise ValueError("a group, not a dataset")
                out[name] = node[()]
            except KeyError:
                raise KeyError(f"{path}: no dataset {name!r}") from None
            except ValueError as e:
                raise ValueError(f"{path}: dataset {name!r}: {e}") from None
    return out


# -- the writer ----------------------------------------------------------------
_UNDEFINED = (1 << 64) - 1  # an address never written, with 8-byte addresses
_LEAF_K, _INTERNAL_K = 4, 16  # the superblock's group K values, h5py's defaults
_BTREE_NODE = 24 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
_SNOD_ENTRY = 40
_SUPERBLOCK = 96
_GCOL_MIN = 4096  # the least global heap collection HDF5 makes
_MAX_MESSAGE = 0xFFFF  # an object header message's size is 16 bits


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _numeric(dtype: np.dtype) -> bool:
    return (dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8)
            or dtype.kind == "f" and dtype.itemsize in _IEEE)


def _datatype_message(dtype: np.dtype) -> bytes:
    big = dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian)
    if dtype.kind == "S":  # fixed-length, null-padded ASCII, as h5py writes numpy S
        return struct.pack("<B3BI", 0x13, 1, 0, 0, dtype.itemsize)
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


def _vlen_string_type(utf8: bool) -> bytes:
    """A variable-length string (class 9, null-terminated, ASCII or UTF-8)
    of 1-byte unsigned characters, as h5py writes ``str`` and ``bytes``."""
    return (struct.pack("<B3BI", 0x19, 0x01, int(utf8), 0, 16)
            + struct.pack("<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8))


def _dataspace_message(shape: tuple[int, ...]) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBB5x", 1, len(shape), 1 if shape else 0) + dims + dims


def _dataset_header(array: np.ndarray, data_addr: int) -> bytes:
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # late allocation, default (zero) fill
    layout = struct.pack("<BBQQ", 3, 1, data_addr, array.nbytes)
    return _object_header([
        _message(_DATASPACE, _dataspace_message(array.shape)),
        _message(_DATATYPE, _datatype_message(array.dtype), flags=1),
        _message(_FILL, fill, flags=1),
        _message(_LAYOUT, layout),
    ])


def _attribute_message(name: str, value: Any, strings: list[bytes], heap: int) -> bytes:
    """A version-1 attribute message holding ``value`` as h5py 3 writes
    it. Variable-length strings are appended to ``strings``, the objects
    of the global heap collection at ``heap`` (object ``i`` is
    ``strings[i - 1]``); each element of the data is a 4-byte length and
    the heap ID (collection address, 4-byte index)."""
    if type(value) in (list, tuple) and not value:
        value = np.zeros(0)  # h5py writes [] as an empty float64 array
    texts = [value] if type(value) in (str, bytes) else value
    kinds = {type(t) for t in texts} if type(texts) in (list, tuple) else set()
    if kinds in ({str}, {bytes}):
        shape: tuple[int, ...] = () if texts is not value else (len(texts),)
        dtype = _vlen_string_type(type(texts[0]) is str)
        data = b""
        for t in texts:
            strings.append(t.encode("utf-8") if type(t) is str else t)
            data += struct.pack("<IQI", len(strings[-1]), heap, len(strings))
    else:
        a = np.asarray(value)
        if type(value) is bool or not (a.dtype.kind == "S" or _numeric(a.dtype)):
            raise ValueError(f"attribute {name!r}: a {type(value).__name__} of {a.dtype} is"
                             " not written (only strings, numpy S arrays and numbers)")
        shape, dtype, data = a.shape, _datatype_message(a.dtype), a.tobytes()
    raw = name.encode("utf-8") + b"\0"
    space = _dataspace_message(shape)
    body = struct.pack("<BBHHH", 1, 0, len(raw), len(dtype), len(space))
    for part in (raw, dtype, space):
        body += part + b"\0" * (-len(part) % 8)
    body += data
    if _pad8(len(body)) > _MAX_MESSAGE:
        raise ValueError(f"attribute {name!r} of {len(body)} bytes: a header message holds"
                         f" at most {_MAX_MESSAGE}")
    return _message(_ATTRIBUTE, body)


def _global_heap(strings: list[bytes]) -> bytes:
    """One global heap collection holding ``strings`` as objects 1, 2, ...
    (reference count 0, as h5py leaves attribute strings), at least
    :data:`_GCOL_MIN` bytes, the rest one free-space object (index 0)."""
    body = b"".join(struct.pack("<HHIQ", i, 0, 0, len(t)) + t + b"\0" * (-len(t) % 8)
                    for i, t in enumerate(strings, start=1))
    size = max(_GCOL_MIN, 16 + len(body))
    free = size - 16 - len(body)
    if free >= 16:
        body += struct.pack("<HHIQ", 0, 0, 0, free)
    return (b"GCOL" + struct.pack("<B3xQ", 1, size) + body).ljust(size, b"\0")


class _GroupSpec:
    """A group to write: its links (name -> group or array) and attributes."""

    def __init__(self):
        self.links: dict[str, _GroupSpec | np.ndarray] = {}
        self.attrs: dict[str, Any] = {}
        self.messages: list[bytes] = []  # its attribute messages, once encoded

    def group(self, path: str) -> "_GroupSpec":
        """The group at ``path`` below this one, made (with the groups on
        the way) where absent."""
        g = self
        for part in _path_parts(path):
            child = g.links.setdefault(part, _GroupSpec())
            if not isinstance(child, _GroupSpec):
                raise ValueError(f"{path!r}: {part!r} is a dataset, not a group")
            g = child
        return g

    def walk(self) -> Iterator["_GroupSpec"]:
        yield self
        for child in self.links.values():
            if isinstance(child, _GroupSpec):
                yield from child.walk()


def _path_parts(path: str) -> list[str]:
    parts = path.strip("/").split("/") if path.strip("/") else []
    if any(not p or "\0" in p or p in (".", "..") for p in parts):
        raise ValueError(f"the path {path!r} has an empty, '.', '..' or NUL name")
    return parts


class _Out:
    """The file's layout: the metadata from ``start`` on, each block at the
    next free address, then the datasets' data from ``data_start`` on, in
    the order their headers were laid out."""

    def __init__(self, start: int, data_start: int):
        self.start, self.meta = start, bytearray()
        self.data_start, self.data_end, self.arrays = data_start, data_start, []

    @property
    def end(self) -> int:
        """The next free metadata address."""
        return self.start + len(self.meta)

    def put(self, block: bytes) -> int:
        self.meta += block
        return self.end - len(block)

    def data(self, a: np.ndarray) -> int:
        if not a.nbytes:
            return _UNDEFINED
        self.arrays.append(a)
        self.data_end += a.nbytes
        return self.data_end - a.nbytes

    def group(self, g: _GroupSpec) -> tuple[int, int, int]:
        """Write ``g``'s links (arrays as their data, then their header),
        then its local heap ("" at 0, each name 8-aligned), symbol-table
        nodes of at most eight names, one B-tree leaf over those nodes
        (key i bounds the names of node i - 1 from above; key 0 is the empty
        name) and its object header. Its (header, B-tree, heap) addresses."""
        entries = []
        for name in sorted(g.links):  # HDF5's order: bytewise, as Python sorts str
            child = g.links[name]
            if isinstance(child, _GroupSpec):
                entries.append((name, self.group(child)[0]))
            else:
                entries.append((name, self.put(_dataset_header(child, self.data(child)))))
        nodes = [entries[i:i + 2 * _LEAF_K] for i in range(0, len(entries), 2 * _LEAF_K)]
        if len(nodes) > 2 * _INTERNAL_K:
            raise ValueError(f"{len(entries)} links in one group: at most"
                             f" {2 * _INTERNAL_K * 2 * _LEAF_K}")
        heap_data, offset = bytearray(8), {}
        for name, _ in entries:
            offset[name] = len(heap_data)
            raw = name.encode("utf-8") + b"\0"
            heap_data += raw + b"\0" * (-len(raw) % 8)
        heap = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1, self.end + 32)
                        + bytes(heap_data))
        snod_size = 8 + 2 * _LEAF_K * _SNOD_ENTRY
        snods = self.end
        for node in nodes:
            block = b"SNOD" + struct.pack("<BBH", 1, 0, len(node))
            for name, header in node:
                block += struct.pack("<QQII16x", offset[name], header, 0, 0)
            self.put(block.ljust(snod_size, b"\0"))
        btree = b"TREE" + struct.pack("<BBHQQQ", 0, 0, len(nodes), _UNDEFINED, _UNDEFINED, 0)
        for i, node in enumerate(nodes):
            btree += struct.pack("<QQ", snods + i * snod_size, offset[node[-1][0]])
        btree_addr = self.put(btree.ljust(_BTREE_NODE, b"\0"))
        table = _message(_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap))
        return self.put(_object_header([table, *g.messages])), btree_addr, heap


def write_datasets(path: str, arrays: Mapping[str, np.ndarray],
                   attrs: Mapping[str, Mapping[str, Any]] | None = None) -> str:
    """Write ``arrays`` as contiguous datasets of a new HDF5 file at
    ``path``, each at its path from the root group ("box",
    "model_weights/dense/dense/kernel:0", the groups on the way made as
    h5py makes them), and ``attrs`` (group path, "" for the root -> {name:
    value}) as attributes of those groups, a group named only there made
    empty. Laid out as ``h5py``'s defaults lay them out: superblock version
    0 with 8-byte addresses, groups held by symbol tables (a version-1
    B-tree over symbol-table nodes of at most eight names, names in a local
    heap), version-1 object headers and attribute messages; the metadata
    first, then each dataset's data in path order.

    Datasets are numeric (1- to 8-byte integers, 4- and 8-byte floats).
    Attribute values are written as h5py 3 writes the same Python value: a
    ``str`` or ``bytes``, or a list of either, as variable-length UTF-8 or
    ASCII strings (in one global heap collection), a numpy ``S`` array as
    fixed-length strings, ``[]`` as an empty float64 array, a number or a
    numeric array as it is. ``h5py`` reads every dataset and attribute back
    bit for bit."""
    root = _GroupSpec()
    for name, a in arrays.items():
        a, parts = np.asarray(a), _path_parts(name)
        if not parts:
            raise ValueError(f"dataset name {name!r}: empty")
        if not _numeric(a.dtype):
            raise ValueError(f"dataset {name!r}: dtype {a.dtype} is not written")
        parent = root.group("/".join(parts[:-1]))
        if parts[-1] in parent.links:
            raise ValueError(f"dataset {name!r}: the name is taken")
        parent.links[parts[-1]] = a
    for group, values in (attrs or {}).items():
        root.group(group).attrs.update(values)
    strings: list[bytes] = []
    for g in root.walk():  # the heap goes first, after the superblock
        g.messages = [_attribute_message(k, v, strings, _SUPERBLOCK) for k, v in g.attrs.items()]

    def layout(data_start: int) -> tuple[_Out, tuple[int, int, int]]:
        out = _Out(_SUPERBLOCK, data_start)
        if strings:
            out.put(_global_heap(strings))
        return out, out.group(root)

    # the metadata's size does not depend on where the data goes: lay it out
    # once to size it, then with the data right behind it
    out, (header, btree, heap) = layout(_SUPERBLOCK + len(layout(0)[0].meta))
    with open(path, "wb") as f:
        f.write(SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, _UNDEFINED, out.data_end, _UNDEFINED)
                + struct.pack("<QQII", 0, header, 1, 0) + struct.pack("<QQ", btree, heap))
        f.write(out.meta)
        for a in out.arrays:
            np.ascontiguousarray(a).tofile(f)  # C order: the transposed dialect too
    return path
