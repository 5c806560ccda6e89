"""Nested groups, attributes and keras saves: the port's HDF5 reader and
writer (``data/h5.py``) against ``h5py``, and its keras walk and import
(``importers.py``) against the JAX package's, which reads through ``h5py``.

Every file is a keras-layout save: written here by ``h5py`` at its defaults
as ``tests/test_importers.py`` writes them (the seven ``KERAS_CASES`` of
``test_torch_importers.py``, and the variants below), written by the port's
own writer, or the one genuine keras 3 save committed under ``tests/data/``.
The reader must give each group's keys in h5py's order and every attribute
and dataset as h5py gives them: type, dtype, shape and value (bits for
arrays). Then ``is_reference_checkpoint``, ``_keras_weight_list`` (names,
dtypes, bits) and the import's outcome (the tree bit for bit, or the
exception's type and message) must equal JAX's. What the reader refuses is
held to a ``ValueError`` naming the feature and the attribute. Files of a
few KB (the ``KERAS_CASES`` up to a few hundred); the file runs in a few
seconds.
"""

import json
import os
from pathlib import Path

import h5py
import numpy as np
import pytest

from pose_estimation_amitai_torch import importers
from pose_estimation_amitai_torch.data import h5
from pose_estimation_amitai_tpu import importers as jimporters

from test_importers import _gen_keras_cnn_weights
from test_torch_importers import KERAS_CASES, _assert_imports_equal, _keras_case

# A genuine keras 3.13.1 save (TF 2.21, h5py 3.14, HDF5 1.14.6) of a tiny
# basic_nn (filters 2, one block, 16x16x4 -> 3), nested sub-models as the
# reference's, made once by:
#
#     import keras
#     from keras import layers
#
#     keras.utils.set_random_seed(0)
#     f, cin, cout = 2, 4, 3
#     x = keras.Input((16, 16, cin))
#     h = x
#     for i in range(3):
#         h = layers.Conv2D(f, 3, padding="same", dilation_rate=2)(h)
#         h = layers.LeakyReLU(0.01)(h)
#     h = layers.MaxPooling2D(2)(h)
#     for i in range(3):
#         h = layers.Conv2D(2 * f, 3, padding="same", dilation_rate=2)(h)
#         h = layers.LeakyReLU(0.01)(h)
#     encoder = keras.Model(x, h, name="Encoder2DAtrous")
#     z = keras.Input((8, 8, 2 * f))
#     decoder = keras.Model(
#         z, layers.Conv2DTranspose(cout, 3, strides=2, padding="same")(z),
#         name="Decoder2D")
#     x_in = keras.Input((16, 16, cin), name="x_in")
#     keras.Model(x_in, decoder(encoder(x_in))).save("keras3_basic_nn.h5")
GENUINE = Path(__file__).parent / "data" / "keras3_basic_nn.h5"
MAX_BYTES = 64 * 1024
ROOT_STRINGS = {"backend": "tensorflow", "keras_version": "2.4.0",
                "model_config": json.dumps({"class_name": "Functional",
                                            "config": {"name": "modèle"}})}


def _basic_nn_layers() -> list:
    """A basic_nn (filters 4, one block, 4 -> 3) as keras saves it:
    [(layer name, [(weight name, array), ...]), ...] in the model's order."""
    enc, dec = _gen_keras_cnn_weights(np.random.default_rng(5), 4, 4, 3, 1)

    def group(name, pairs):
        return name, [(f"{name}/conv2d{f'_{i}' if i else ''}/{leaf}:0", a)
                      for i, pair in enumerate(pairs) for leaf, a in zip(("kernel", "bias"), pair)]

    return [("x_in", []), group("Encoder2DAtrous", enc), group("Decoder2D", dec)]


def _write_h5py(path, layers, variant: str) -> None:
    """The keras layout through h5py: ``layer_names`` as fixed-length
    strings (h5py 2.x's), split into ``layer_names0``/``layer_names1`` (as
    keras splits one over 64,512 bytes), or variable-length as h5py 3
    writes a list of bytes; a weightless layer's ``weight_names`` an empty
    float64 array; the root's scalar UTF-8 strings; a 512-byte user block."""
    names = [n.encode() for n, _ in layers]
    with h5py.File(path, "w", userblock_size=512 if variant == "user_block" else 0) as f:
        f.attrs.update(ROOT_STRINGS)
        mw = f.create_group("model_weights")
        if variant == "fixed_length_names":
            mw.attrs["layer_names"] = np.array(names)
        elif variant == "split_layer_names":
            mw.attrs["layer_names0"], mw.attrs["layer_names1"] = names[:2], names[2:]
        else:
            mw.attrs["layer_names"] = names
        for name, ws in layers:
            g = mw.create_group(name)
            for w, a in ws:
                g.create_dataset(w, data=a)
            wn = [w.encode() for w, _ in ws]
            g.attrs["weight_names"] = np.array(wn) if variant == "fixed_length_names" and wn else wn


def _write_port(path, layers) -> None:
    """The same layout through the port's writer."""
    attrs = {"": ROOT_STRINGS, "model_weights": {"layer_names": [n.encode() for n, _ in layers]}}
    arrays = {}
    for name, ws in layers:
        attrs[f"model_weights/{name}"] = {"weight_names": [w.encode() for w, _ in ws]}
        arrays.update((f"model_weights/{name}/{w}", a) for w, a in ws)
    h5.write_datasets(path, arrays, attrs)


def _file(tmp_path, case: str) -> str:
    if case in KERAS_CASES:
        return _keras_case(tmp_path, case)[0]
    if case == "genuine_keras3":
        return str(GENUINE)
    path = str(tmp_path / f"{case}.h5")
    if case == "port_writer":
        _write_port(path, _basic_nn_layers())
    else:
        _write_h5py(path, _basic_nn_layers(), case)
    return path


def _same(got, want, where: str) -> None:
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got, want)
        if want.dtype == object:
            assert got.tolist() == want.tolist(), where
        else:
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), where
    else:
        assert got == want, where


def _equal_to_h5py(path: str) -> None:
    """Every group's keys, every attribute and every dataset of ``path``
    as h5py reads them."""

    def walk(got, want):
        assert got.keys() == list(want.keys()), want.name
        assert list(got.attrs) == list(want.attrs), want.name
        for k in want.attrs:
            _same(got.attrs[k], want.attrs[k], f"{want.name} @{k}")
        for k in want.keys():
            if isinstance(want[k], h5py.Group):
                assert isinstance(got[k], h5.Group)
                walk(got[k], want[k])
            else:
                assert isinstance(got[k], h5.Dataset)
                _same(got[k][()], np.asarray(want[k][()]), want[k].name)
                assert list(got[k].attrs) == list(want[k].attrs)

    with h5py.File(path, "r") as want, h5.File(path) as got:
        walk(got, want)


def _outcome(importer, path):
    try:
        return importer(path)
    except Exception as e:  # the outcome compared: its type and message
        return type(e), str(e)


@pytest.mark.parametrize("case", KERAS_CASES + (
    "fixed_length_names", "split_layer_names", "user_block", "port_writer", "genuine_keras3"))
def test_keras_saves_read_as_h5py_and_import_as_jax(tmp_path, case):
    path = _file(tmp_path, case)
    assert case in KERAS_CASES or os.path.getsize(path) <= MAX_BYTES
    _equal_to_h5py(path)
    assert importers.is_reference_checkpoint(path) == jimporters.is_reference_checkpoint(path)
    assert importers.is_reference_checkpoint(path)
    got, want = importers._keras_weight_list(path), jimporters._keras_weight_list(path)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    got, want = (_outcome(m.import_reference_checkpoint, path) for m in (importers, jimporters))
    if isinstance(want, tuple):
        assert got == want
    else:
        _assert_imports_equal(got, want)


def test_the_genuine_keras3_save_imports_as_a_basic_nn():
    """keras 3 names weights without ":0" and saves a weightless
    ``top_level_model_weights`` group; the import is the tf basic_nn."""
    with h5.File(str(GENUINE)) as f:
        assert f.attrs["keras_version"] == "3.13.1"
        assert f["model_weights"].attrs["layer_names"].tolist() == [
            "x_in", "Encoder2DAtrous", "Decoder2D"]
        empty = f["model_weights/top_level_model_weights"].attrs["weight_names"]
        assert empty.dtype == np.float64 and empty.shape == (0,)
    imported = importers.import_reference_checkpoint(str(GENUINE))
    assert (imported.model_kind, imported.arch_flavor) == ("basic_cnn", "tf")
    assert imported.arch_kwargs == {"out_channels": 3, "in_channels": 4, "filters": 2,
                                    "kernel_size": 3, "dilation": 2, "num_blocks": 1}


def test_port_writer_attributes_read_back_by_h5py(tmp_path):
    """Each kind of attribute value the writer takes, on the root, on a
    nested group and on an empty group, as h5py 3 writes the same value."""
    values = {"s": "é", "b": b"abc", "empty_s": "", "strs": ["a", "éé"], "bins": [b"x", b""],
              "none": [], "fixed": np.array([b"ab", b"c"]), "fixed_1": np.bytes_("hi"),
              "i": 3, "f": 2.5, "i2": np.int16(-7), "big": np.arange(6, dtype=">f4").reshape(2, 3),
              "u8": np.arange(4, dtype=np.uint8)}
    path = str(tmp_path / "w.h5")
    h5.write_datasets(path, {"g/h/x": np.arange(3.0)}, {"": values, "g/h": values, "e": values})
    ref = str(tmp_path / "r.h5")
    with h5py.File(ref, "w") as f:
        for g in (f, f.create_group("g/h"), f.create_group("e")):
            g.attrs.update(values)
    with h5py.File(path, "r") as w, h5py.File(ref, "r") as r:
        for g in ("/", "g/h", "e"):
            assert list(w[g].attrs) == list(r[g].attrs)
            for k in r[g].attrs:
                _same(w[g].attrs[k], r[g].attrs[k], f"{g} @{k}")
    _equal_to_h5py(path)


@pytest.mark.parametrize("value", [True, np.array(["u"]), ["a", b"b"], np.zeros(9000),
                                   np.zeros(2, [("a", "i4")])])
def test_writer_refuses_attributes_it_does_not_write(tmp_path, value):
    """A bool (h5py writes an enum), a unicode array, a list of str and
    bytes, an attribute over an object header message's 65,535 bytes, a
    compound array."""
    with pytest.raises(ValueError, match="attribute 'a'"):
        h5.write_datasets(str(tmp_path / "w.h5"), {}, {"": {"a": value}})


def _patch_version(path, name: str, version: int) -> None:
    """Set the version byte of attribute ``name``'s message: h5py 3.14
    writes version 1 only, so versions 2 and 3 are made so; for version 3
    the name moves one byte on, behind its encoding byte (ASCII), within
    version 1's padding."""
    raw = bytearray(Path(path).read_bytes())
    key = name.encode() + b"\0"
    at = raw.index(key) - 8
    assert raw.count(key) == 1 and raw[at] == 1 and len(key) % 8  # room for a byte more
    raw[at] = version
    if version == 3:
        raw[at + 8:at + 9 + len(key)] = b"\0" + key
    Path(path).write_bytes(bytes(raw))


@pytest.mark.parametrize("case, feature", [
    ("track_order", "version-2 object header"),
    ("attribute_v2", "'layer_names': attribute message version 2"),
    ("attribute_v3", "'layer_names': attribute message version 3"),
    ("compound", "'layer_names': the compound datatype"),
    ("vlen_sequence", "'layer_names': the variable-length sequence datatype"),
    ("enum", "'layer_names': the enumerated datatype"),
])
def test_refusals_name_the_feature_and_the_attribute(tmp_path, case, feature):
    """A group h5py makes with ``track_order=True`` (a version-2 object
    header), attribute messages of versions 2 and 3, and attribute
    datatypes the reader does not read: h5py reads each file's attributes
    (before a version byte is changed), the port's reader raises a
    ValueError naming the feature (and the attribute), on the keras walk
    and on ``attrs``."""
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights", track_order=case == "track_order")
        mw.attrs["layer_names"] = {
            "compound": np.zeros(2, [("a", "<i4"), ("b", "<f8")]),
            "enum": np.array([True, False]),
        }.get(case, [b"x_in"])
        if case == "vlen_sequence":
            seq = np.empty(1, object)
            seq[0] = np.arange(3, dtype=np.int32)
            mw.attrs.create("layer_names", seq, dtype=h5py.vlen_dtype(np.int32))
        mw.create_group("x_in").attrs["weight_names"] = []
    with h5py.File(path, "r") as f:
        f["model_weights"].attrs.get("layer_names")  # h5py reads each
    if case.startswith("attribute_v"):
        _patch_version(path, "layer_names", int(case[-1]))
    with pytest.raises(ValueError, match=feature):
        importers._keras_weight_list(path)
    with h5.File(path) as f, pytest.raises(ValueError, match=feature):
        f["model_weights"].attrs


def test_paths_below_the_root_read_as_h5py(tmp_path):
    """read_datasets takes paths below the root, absolute or not, through
    groups at any depth; a path through a dataset is missing."""
    path = str(tmp_path / "n.h5")
    rng = np.random.default_rng(3)
    arrays = {"a/b/c": rng.random((2, 3)), "a/d": np.arange(4, dtype=">i2"), "e": np.zeros(0)}
    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a)
    got = h5.read_datasets(path, ["/a/b/c", *arrays])
    for name, a in arrays.items():
        assert got[name].dtype == a.dtype and got[name].tobytes() == a.tobytes()
    assert got["/a/b/c"].tobytes() == arrays["a/b/c"].tobytes()
    with h5.File(path) as f:
        assert "a/b" in f and "a/b/c" in f and "a/d/x" not in f and "a/x" not in f
        assert isinstance(f["a"]["b"], h5.Group) and f["a"].keys() == ["b", "d"]
    with pytest.raises(KeyError, match="'e/x'"):
        h5.read_datasets(path, ["e/x"])
