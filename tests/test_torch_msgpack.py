"""The port's flax msgpack codec (``weights.unpack_flax_msgpack`` and
``weights.pack_flax_msgpack``, with neither ``msgpack`` nor jax) against
``flax.serialization``.

Each tree goes through flax's ``to_bytes`` (the JAX package's
``save_params`` and ``save_checkpoint``): the port's packer must give the
same bytes from flax's state dict of the tree, and the port's reader must
give what ``msgpack_restore`` gives (bfloat16 leaves widened to float32):
the same containers, keys in the same order, the same leaf types, dtypes,
shapes and bits. The trees cover the flagship and ViT parameters at small
widths, a full training-state payload, bfloat16 leaves, numpy scalars, ints
across every width boundary, strings and bins across every length boundary,
and lists (as msgpack_serialize packs a tree given as it is). Malformed
input raises ``ValueError``. About a second in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import serialization

from pose_estimation_amitai_torch import weights
from pose_estimation_amitai_tpu.train import checkpoint as jckpt
from pose_estimation_amitai_tpu.train.loop import TrainState

LENGTHS = (0, 15, 16, 31, 32, 255, 256, 65535, 65536)  # each encoding's edges
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _numpy(tree):
    """flax's state dict as ``msgpack_serialize`` packs it: jax arrays as
    numpy, containers and order as they are."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def _tree(case: str, tmp_path):
    """(the tree flax serialises, its bytes as the JAX package writes them)."""
    rng = np.random.default_rng(len(case))
    if case == "flagship":
        tree = weights.init_basicnet_params(rng, 4, 6, filters=8)
    elif case == "vit":
        tree = weights.init_vit_params(rng, 4, 6, 48, dim=32, depth=2, heads=2, dim_head=16)
    elif case == "train_state":  # save_checkpoint's step, params, opt_state, batch_stats, rng
        params = jax.tree_util.tree_map(jnp.asarray, weights.init_basicnet_params(rng, 4, 6, 8))
        tree = TrainState(step=jnp.asarray(7, jnp.int32), params=params,
                          opt_state=optax.adam(1e-3).init(params), batch_stats={},
                          rng=jax.random.key(3))
        path = jckpt.save_checkpoint(str(tmp_path), tree, epoch=1, val_loss=0.5)
        with open(path, "rb") as f:
            return jckpt._state_payload(tree), f.read()
    elif case == "bf16":
        tree = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16),
                                      weights.init_basicnet_params(rng, 4, 6, filters=8))
    elif case == "scalars":
        tree = {"f32": np.float32(2.5), "f64": np.float64(-0.125), "i8": np.int8(-3),
                "u64": np.uint64(2 ** 64 - 1), "bool": np.bool_(True), "f16": np.float16(1.5),
                "bf16": jnp.bfloat16(1.5), "zero_d": np.array(7, np.int32),
                "empty": np.zeros((0, 3), np.float32), "python": [1.5, None, True, False]}
    elif case == "ints":
        tree = {"ints": INTS, "maps": {str(n): {str(i): i for i in range(n)} for n in (15, 16)},
                "lists": [list(range(n)) for n in (15, 16)]}
    else:  # strings and bins at each length edge
        tree = {f"s{n}": "é" * (n // 2) + "x" * (n % 2) for n in LENGTHS}
        tree.update({f"b{n}": b"\xff" * n for n in LENGTHS})
        tree["keys"] = {"k" * n: n for n in (31, 32, 255, 256)}
    path = str(tmp_path / "tree.msgpack")
    jckpt.save_params(path, tree)
    with open(path, "rb") as f:
        return tree, f.read()


def _same(got, want, where: str = "") -> None:
    if isinstance(want, dict):
        assert type(got) is dict and list(got) == list(want), where
        for k in want:
            _same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert type(got) is list and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{where}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype.name == "bfloat16":  # widened to float32 by the port
            want = want.astype(np.float32)
        assert type(got) is type(want) and got.dtype == want.dtype, (where, got, want)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("case", ["flagship", "vit", "train_state", "bf16", "scalars", "ints",
                                  "strings_bins"])
def test_codec_equals_flax(tmp_path, case):
    tree, blob = _tree(case, tmp_path)
    state = _numpy(serialization.to_state_dict(tree))
    assert blob == serialization.to_bytes(tree)
    assert weights.pack_flax_msgpack(state) == blob
    assert serialization.msgpack_serialize(state, in_place=True) == blob
    _same(weights.unpack_flax_msgpack(blob), serialization.msgpack_restore(blob))


def test_lists_pack_and_unpack_as_flax():
    """flax's state dicts turn lists into maps, so msgpack arrays come only
    from a tree given to msgpack_serialize as it is: each array length edge."""
    tree = {"ints": INTS, "lists": [list(range(n)) for n in (15, 16, 65536)],
            "nested": [[np.float32(1), np.arange(3)], {"a": [None, "x"]}]}
    blob = serialization.msgpack_serialize(_numpy(tree), in_place=True)
    assert weights.pack_flax_msgpack(tree) == blob
    _same(weights.unpack_flax_msgpack(blob), serialization.msgpack_restore(blob))


def test_save_checkpoint_run_directory_loads(tmp_path):
    """A run directory JAX's save_checkpoint wrote: load_flax_checkpoint
    gives its params (and empty batch_stats) as msgpack_restore gives them."""
    tree, blob = _tree("train_state", tmp_path)
    params, stats = weights.load_flax_checkpoint(str(tmp_path))
    assert stats == {}
    _same(params, serialization.msgpack_restore(blob)["params"])


@pytest.mark.parametrize("blob, message", [
    (b"", "ends early"),
    (b"\x82\xa1a\x01", "ends early"),  # a map of two with one pair
    (b"\xdb\x00\x00\x01\x00abc", "ends early"),  # str 32 of 256 bytes, 3 there
    (b"\xc1", "type byte 0xC1"),
    (b"\xd4\x05\x00", "ext type 5"),
    (b"\x81\x01\x02", "map key of type int"),
    (b"\x90\x00", "1 bytes after"),
    (b"\xd7\x01\x93\x91\x01\xa7float32\xc4\x00", "ends early"),  # an ndarray cut short
])
def test_malformed_input_raises(blob, message):
    with pytest.raises(ValueError, match=message):
        weights.unpack_flax_msgpack(blob)


def test_truncated_checkpoint_and_complex_raise(tmp_path):
    """Any cut of a real checkpoint raises; flax's native-complex ext (2)
    is refused by name, as every code other than 1 and 3 is."""
    _, blob = _tree("flagship", tmp_path)
    for cut in (1, 7, len(blob) // 3, len(blob) - 1):
        with pytest.raises(ValueError):
            weights.unpack_flax_msgpack(blob[:cut])
    with pytest.raises(ValueError, match="ext type 2"):
        weights.unpack_flax_msgpack(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(TypeError):
        weights.pack_flax_msgpack({"t": (1, 2)})  # msgpack's strict packer refuses a tuple
