"""The port's HDF5 reader and writer (``data/h5.py``) against ``h5py``.

Every case writes a small file with ``h5py`` (imported here only) at its
default settings, the contract's producers' format, and holds
``read_datasets`` to ``h5py.File(path)[name][()]``: equal dtype, shape and
bytes. What the reader refuses is held to a ``ValueError`` naming the
feature, and each contract file that JAX's ``Preprocessor`` reads but the
port's refuses is written and tried on both. The files are a few KB each
(every file is asserted under ``MAX_BYTES``; the largest, the two-level
chunk B-tree, is about 40 KB); the file runs in a few seconds.
"""

import os

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pose_estimation_amitai_torch.data import h5
from pose_estimation_amitai_torch.data.preprocess import Preprocessor
from pose_estimation_amitai_tpu.data.preprocess import Preprocessor as JPreprocessor

MAX_BYTES = 64 * 1024

DTYPES = ["u1", "i2", "i4", "i8", "f4", "f8", ">f4", ">i4"]
LAYOUTS = {
    "contiguous": {},
    "chunked": {"chunks": (2, 4, 3)},  # edge chunks cut in every dimension
    "one_chunk": {"chunks": (5, 6, 7)},
    "deflate": {"chunks": (2, 4, 3), "compression": "gzip"},
}


def _array(rng, shape, dtype) -> np.ndarray:
    a = np.asarray(rng.random(shape) * 200 - (0 if dtype.startswith("u") else 100))
    return a.astype(dtype)


def _equal_to_h5py(path, names=None) -> dict:
    assert os.path.getsize(path) <= MAX_BYTES, os.path.getsize(path)
    with h5py.File(path, "r") as f:
        names = names or list(f.keys())
        want = {n: np.asarray(f[n][()]) for n in names}
    got = h5.read_datasets(str(path), names)
    assert list(got) == names
    for n in names:
        assert got[n].dtype == want[n].dtype, (n, got[n].dtype, want[n].dtype)
        assert got[n].shape == want[n].shape, (n, got[n].shape, want[n].shape)
        assert got[n].tobytes() == want[n].tobytes(), n
    return got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_filters_and_dtypes_read_as_h5py(tmp_path, layout, dtype):
    """(5, 6, 7) arrays: ~2-4 KB files (the chunked ones ~5 KB)."""
    a = _array(np.random.default_rng(len(dtype) + len(layout)), (5, 6, 7), dtype)
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=a, **LAYOUTS[layout])
    _equal_to_h5py(path)


@pytest.mark.parametrize("ndim, layout", [
    (n, layout) for n in range(6) for layout in ("contiguous", "deflate")
    if n or layout != "deflate"  # a scalar dataset has no chunks
])
def test_shapes_0d_to_5d_read_as_h5py(tmp_path, ndim, layout):
    """0-d (a numpy scalar from h5py, native order) to 5-d: ~1-3 KB files."""
    shape = (3, 4, 2, 5, 3)[:ndim]
    a = _array(np.random.default_rng(ndim), shape, ">f8")
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=a, **({"chunks": (2,) * ndim, "compression": "gzip"}
                                         if layout == "deflate" else {}))
    got = _equal_to_h5py(path)["x"]
    assert got.shape == shape


@pytest.mark.parametrize("user_block", [512, 1024])
def test_user_block_as_matlab_writes_it(tmp_path, user_block):
    """The layout of MATLAB's -v7.3 files, made with h5py (no MATLAB export
    is read here): a user block, column-major (h5py's reversed shape comes
    back as is), chunked with deflate: ~3-7 KB files."""
    rng = np.random.default_rng(user_block)
    path = tmp_path / "a.mat"
    with h5py.File(path, "w", userblock_size=user_block) as f:
        f.create_dataset("box", data=_array(rng, (5, 8, 8, 2), "u1").T, chunks=(2, 8, 4, 3),
                         compression="gzip")
        f.create_dataset("points_3D", data=_array(rng, (3, 2, 6), "f8"))
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file")
    got = _equal_to_h5py(path)
    assert got["box"].shape == (2, 8, 8, 5)


def test_chunks_the_filter_mask_skips(tmp_path):
    """A chunk's filter mask skips deflate for that chunk alone: a chunk
    written directly with deflate skipped (bit 0), beside deflated
    chunks: ~3 KB."""
    a = np.random.default_rng(5).integers(0, 1000, (4, 128), dtype=np.uint16)
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=a, chunks=(1, 128), compression="gzip")
        ds.id.write_direct_chunk((2, 0), a[2].tobytes(), filter_mask=0b1)
    got = _equal_to_h5py(path)["x"]
    np.testing.assert_array_equal(got, a)


def test_chunk_indexes_over_a_larger_extent_and_many_chunks(tmp_path):
    """Chunked datasets that may grow (a larger maximal extent, an
    unlimited dimension: still a version-1 B-tree at h5py's defaults), a
    B-tree of two levels (1,100 chunks), and chunks allocated early, then
    written: ~40 KB."""
    rng = np.random.default_rng(3)
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("grown", data=_array(rng, (5, 6), "i4"), maxshape=(8, 9), chunks=(3, 3),
                         compression="gzip")
        f.create_dataset("unlimited", data=_array(rng, (7, 5), "f4"), maxshape=(None, 5),
                         chunks=(2, 5))
        f.create_dataset("many", data=_array(rng, (1100,), "i1"), chunks=(1,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((3, 4))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        space = h5py.h5s.create_simple((7, 9))
        h5py.h5d.create(f.id, b"early", h5py.h5t.py_create(np.dtype("f4")), space, dcpl=dcpl)
        f["early"][...] = _array(rng, (7, 9), "f4")
    _equal_to_h5py(path)


def test_headers_with_continuation_blocks_and_many_links(tmp_path):
    """Attributes grow each object header into a continuation block; the
    root holds a group and 20 datasets over three symbol-table nodes:
    ~12 KB."""
    path = tmp_path / "a.h5"
    with h5py.File(path, "w") as f:
        for i in range(20):
            ds = f.create_dataset(f"d{i:02d}", data=np.full(3, i, "i2"))
            if i < 2:
                for j in range(3):
                    ds.attrs[f"attr{j}"] = np.arange(200)
        f.create_group("grp")
    _equal_to_h5py(path, [f"d{i:02d}" for i in range(20)])


@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_random_shapes_and_chunks_read_as_h5py(tmp_path, data):
    """Random shapes (1-4 dimensions of 1-9) and chunk shapes (at most 3
    chunks a dimension), deflate or not, and dtype, drawn the same in every
    run: files under ~20 KB."""
    shape = tuple(data.draw(st.lists(st.integers(1, 9), min_size=1, max_size=4), label="shape"))
    chunks = tuple(data.draw(st.integers(-(-s // 3), s), label="chunk") for s in shape)
    dtype = data.draw(st.sampled_from(DTYPES), label="dtype")
    filters = data.draw(st.sampled_from([{}, {"compression": "gzip"}]))
    a = _array(np.random.default_rng(sum(shape)), shape, dtype)
    path = tmp_path / "h.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=a, chunks=chunks, **filters)
    _equal_to_h5py(path)


@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_files_read_back_by_h5py(tmp_path, dtype):
    """Every written dtype at 0-d to 5-d, an empty array and a transposed
    (non-contiguous) view: ~4 KB files, read back by h5py and by the
    reader bit for bit."""
    rng = np.random.default_rng(len(dtype))
    arrays = {f"d{n}": _array(rng, (3, 2, 4, 1, 2)[:n], dtype) for n in range(6)}
    arrays["empty"] = np.zeros((0, 3), dtype)
    arrays["transposed"] = _array(rng, (3, 5), dtype).T
    path = str(tmp_path / "w.h5")
    assert h5.write_datasets(path, arrays) == path
    assert os.path.getsize(path) <= MAX_BYTES
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(arrays)
        for name, a in arrays.items():
            got = np.asarray(f[name][()])
            want = a if a.ndim else a.astype(a.dtype.newbyteorder("="))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name
    _equal_to_h5py(path)


def test_writer_spreads_many_names_over_symbol_table_nodes(tmp_path):
    """40 names over five symbol-table nodes (eight a node): ~14 KB; h5py
    reads them and can append to the file."""
    arrays = {f"n{i:02d}": np.arange(i % 5 + 1, dtype="i2") for i in range(40)}
    path = str(tmp_path / "w.h5")
    h5.write_datasets(path, arrays)
    with h5py.File(path, "a") as f:
        assert sorted(f.keys()) == sorted(arrays)
        f.create_dataset("zz", data=np.arange(3))
    _equal_to_h5py(path, [*arrays, "zz"])


@pytest.mark.parametrize("bad", [{"x": np.ones(2), "x/y": np.ones(2)}, {"x": np.ones(2, bool)},
                                 {"x": np.ones(2, np.float16)}])
def test_writer_refuses_what_it_does_not_write(tmp_path, bad):
    with pytest.raises(ValueError):
        h5.write_datasets(str(tmp_path / "w.h5"), bad)


def _compact(f, name: str, a: np.ndarray) -> None:
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(a.dtype),
                         h5py.h5s.create_simple(a.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(a))


@pytest.mark.parametrize("case, feature", [
    ("superblock_1", "superblock version 1"),
    ("superblock_2", "superblock version 2"),
    ("superblock_3", "superblock version 3"),
    ("compact", "compact layout"),
    ("never_written", "storage never written"),
    ("chunks_never_written", "chunks never written"),
    ("shuffle", "shuffle filter"),
    ("fletcher32", "fletcher32 filter"),
    ("lzf", "lzf filter"),
    ("szip", "szip filter"),
    ("vlen_string", "variable-length datatype"),
    ("fixed_string", "string datatype"),
    ("float16", "2-byte float"),
    ("bool", "enumerated datatype"),
    ("nested", "version-2 object header"),
    ("group", "a group, not a dataset"),
    ("soft_link", "a soft link"),
    ("truncated", "past the end of the file"),
    ("not_hdf5", "no signature"),
])
def test_refusals_name_the_feature_and_the_dataset(tmp_path, case, feature):
    """Each refusal is a ValueError naming what is not read (and the
    dataset, where one is at fault); never a partial read: ~1-6 KB files.
    h5py cannot write superblock 1 (it needs a non-default chunk B-tree K,
    which h5py does not set), so that file is an h5py file with its
    version byte changed."""
    path = tmp_path / "r.h5"
    name = "x"
    libver = {"superblock_2": ("v108", "latest"), "superblock_3": "latest"}.get(case, "earliest")
    with h5py.File(path, "w", libver=libver) as f:
        if case == "nested":  # a dataset below a group h5py gives a version-2 header
            f.create_group("g", track_order=True).create_dataset("x", data=np.arange(3))
            name = "g/x"
        elif case == "group":
            f.create_group("x")
        elif case == "soft_link":
            f.create_dataset("y", data=np.arange(3))
            f["x"] = h5py.SoftLink("/y")
        elif case == "compact":
            _compact(f, "x", np.arange(10, dtype="i4"))
        elif case == "chunks_never_written":
            f.create_dataset("x", shape=(9, 10), dtype="f4", chunks=(4, 4))[2:6, 5:] = 1.5
        else:
            kw = {
                "never_written": dict(shape=(9, 10), dtype="i2"),
                "shuffle": dict(data=np.arange(100, dtype="i4"), chunks=(50,), shuffle=True),
                "fletcher32": dict(data=np.arange(100, dtype="i4"), chunks=(50,),
                                   fletcher32=True),
                "lzf": dict(data=np.ones(100), compression="lzf"),
                "szip": dict(data=np.ones(100), compression="szip"),
                "vlen_string": dict(data=["ab", "cde"], dtype=h5py.string_dtype()),
                "fixed_string": dict(data=np.bytes_("hello")),
                "float16": dict(data=np.ones(3, np.float16)),
                "bool": dict(data=np.array([True, False])),
            }.get(case, dict(data=np.arange(10)))
            f.create_dataset("x", **kw)
    if case == "superblock_1":
        raw = bytearray(path.read_bytes())
        raw[8] = 1
        path.write_bytes(bytes(raw))
    elif case == "truncated":  # the last bytes of the dataset's data
        path.write_bytes(path.read_bytes()[:-10])
    elif case == "not_hdf5":
        path.write_bytes(b"\0" * 600)
    with pytest.raises(ValueError, match=feature) as err:
        h5.read_datasets(str(path), [name])
    if not case.startswith("superblock") and case != "not_hdf5":  # file-level faults
        assert repr(name) in str(err.value)


def test_a_missing_name_raises_key_error(tmp_path):
    path = str(tmp_path / "w.h5")
    h5.write_datasets(path, {"box": np.zeros(2)})
    with pytest.raises(KeyError, match="'nope'"):
        h5.read_datasets(path, ["box", "nope"])


def _contract_arrays() -> dict:
    """The five contract datasets at the least size the loaders take: one
    frame of four 8x8 views."""
    rng = np.random.default_rng(0)
    return {"box": rng.random((1, 4, 8, 8, 5), np.float32),
            "confmaps": rng.random((1, 4, 8, 8, 2), np.float32),
            "points_3D": rng.random((1, 2, 3), np.float32),
            "cropZone": rng.integers(0, 50, (1, 4, 2)).astype(np.int32),
            "cameras_dlt_array": rng.random((4, 3, 4), np.float32)}


@pytest.mark.parametrize("case, feature", [
    ("libver_v108", "superblock version 2"),
    ("libver_latest", "superblock version 3"),
    ("unlimited_latest", "superblock version 3"),
    ("dense_links_latest", "superblock version 3"),
    ("compact", "compact layout"),
    ("never_written", "storage never written"),
    ("chunks_never_written", "chunks never written"),
    ("shuffle", "shuffle filter"),
    ("fletcher32", "fletcher32 filter"),
    ("lzf", "lzf filter"),
    ("szip", "szip filter"),
])
def test_contract_files_jax_reads_and_the_port_refuses(tmp_path, case, feature):
    """The files JAX's loader (h5py) reads and the port's reader refuses:
    the five contract datasets with one feature outside h5py's defaults.
    JAX's ``Preprocessor._load_h5`` loads each; the port's raises a
    ValueError naming the feature. ~6-12 KB files. Not written here: blosc
    chunks (h5py has no blosc encoder of its own), superblock 1 and partial edge
    chunks stored unfiltered (h5py cannot set either)."""
    arrays = _contract_arrays()
    path = tmp_path / "c.h5"
    libver = {"libver_v108": ("v108", "latest")}.get(
        case, "latest" if case.endswith("_latest") else "earliest")
    box_kw = {"unlimited_latest": dict(maxshape=(None, 4, 8, 8, 5), chunks=(1, 4, 8, 8, 5)),
              "shuffle": dict(chunks=(1, 2, 8, 8, 5), shuffle=True),
              "fletcher32": dict(chunks=(1, 2, 8, 8, 5), fletcher32=True),
              "lzf": dict(compression="lzf"),
              "szip": dict(compression="szip")}.get(case, {})
    with h5py.File(path, "w", libver=libver) as f:
        for name, a in arrays.items():
            if name == "box" and case == "chunks_never_written":
                f.create_dataset(name, shape=a.shape, dtype=a.dtype, chunks=(1, 1, 8, 8, 5))[
                    :, :2] = a[:, :2]
            elif name == "confmaps" and case == "never_written":
                f.create_dataset(name, shape=a.shape, dtype=a.dtype)
            elif name == "cropZone" and case == "compact":
                _compact(f, name, a)
            else:
                f.create_dataset(name, data=a, **(box_kw if name == "box" else {}))
        if case == "dense_links_latest":  # more than 8 links: a fractal heap
            for i in range(6):
                f.create_dataset(f"extra{i}", data=np.arange(3))
    assert os.path.getsize(path) <= MAX_BYTES
    want = JPreprocessor._load_h5(str(path))
    assert want["box"].shape == (1, 4, 8, 8, 5)
    with pytest.raises(ValueError, match=feature):
        Preprocessor._load_h5(str(path))
