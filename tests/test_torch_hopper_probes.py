"""The probe kernels' plain versions (what the wrappers run on CPU tensors).

S3, ``scripts/exp_im2col_bisect.py``: each plain version against the script's
own kernel body, run through a ``pl.pallas_call(..., interpret=True)`` built
here as ``run_case`` and ``run_full`` build theirs (the bodies are
module-level functions; nothing in the script changes). S4,
``scripts/exp_mosaic_probe.py``: its bodies are closures, so each plain
version is held against the script's own numpy expectation, and against the
same arithmetic in jnp. Integer results: equal, every element."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pose_estimation_amitai_torch.ops import hopper_probes as hp
from pose_estimation_amitai_torch.ops import hopper_qconv as hq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bisect():
    spec = importlib.util.spec_from_file_location(
        "exp_im2col_bisect", os.path.join(ROOT, "scripts", "exp_im2col_bisect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_case(mod, kernel, scratch_shapes, x):
    """``run_case``'s pallas_call, interpreted."""
    fn = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=mod.O8, scratch_shapes=scratch_shapes, interpret=True)
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["k_copy", "k_stage", "k_dyn_read", "k_reshape",
                                  "k_concat_dot"])
def test_bisect_case_matches_pallas_body(bisect, name):
    x = hp.run_case_input("cpu")
    assert x.shape == (1, 192, 192, 64) and x.dtype == torch.int8
    scratch = [] if name == "k_copy" else [bisect.XPAD]
    want = _run_case(bisect, getattr(bisect, name), scratch, x.numpy())
    plain = getattr(hp, name + "_plain")(x)
    assert plain.dtype == torch.int8 and plain.is_contiguous()
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(getattr(hp, name)(x).numpy(), want)  # CPU -> plain
    if name == "k_concat_dot":  # the clip is reached, and not everywhere
        assert np.abs(want).max() == 127 and (np.abs(want) < 127).mean() > 0.05
    else:
        np.testing.assert_array_equal(want, x.numpy())


@pytest.mark.parametrize("grid_b", [1, 4])
def test_full_epilogue_matches_pallas_body(bisect, grid_b):
    """``run_full``'s pallas_call (grid over frames), interpreted. XLA may
    contract ``acc * m + b`` into one rounding where the source and the port
    have two: at most one quantum on at most 0.1% of the elements."""
    x, w, m, b = hp.run_full_inputs(grid_b, "cpu")
    hw, c = bisect.HW, bisect.C
    wspec = pl.BlockSpec(memory_space=pltpu.VMEM)
    frame = pl.BlockSpec((1, hw, hw, c), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        bisect.full_kernel, grid=(grid_b,), in_specs=[frame, wspec, wspec, wspec],
        out_specs=frame, out_shape=jax.ShapeDtypeStruct((grid_b, hw, hw, c), jnp.int8),
        scratch_shapes=[bisect.XPAD], interpret=True)
    want = np.asarray(jax.jit(fn)(*[jnp.asarray(a.numpy()) for a in (x, w, m, b)]))
    plain = hp.full_epilogue_plain(x, w, m, b)
    assert plain.shape == want.shape and plain.dtype == torch.int8
    assert np.abs(want).max() == 127 and np.abs(want).mean() > 10
    diff = np.abs(plain.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    np.testing.assert_array_equal(hp.full_epilogue(x, w, m, b).numpy(), plain.numpy())
    packed = hq.pack_qconv_weights(hp._hwio(w))  # packed once, as the card's run does
    np.testing.assert_array_equal(hp.full_epilogue(x, packed, m, b).numpy(), plain.numpy())


def test_run_full_inputs_are_the_scripts():
    x1, w1, m1, b1 = hp.run_full_inputs(1, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(x1.numpy(), rng.integers(-80, 80, (1, 192, 192, 64)))
    np.testing.assert_array_equal(w1.numpy(), rng.integers(-90, 90, (576, 64)))
    assert m1.dtype == b1.dtype == torch.float32 and m1.shape == b1.shape == (64,)
    # im2col rows are tap-major, channel-minor: (3, 3, C, Cout) as it lies
    assert torch.equal(hp._hwio(w1)[1, 2, 5], w1[(1 * 3 + 2) * 64 + 5])


def test_concat_dot_plain_on_ragged_frame():
    """All-ones weights: every output channel is the clipped 9-tap sum over
    all input channels, zero outside the frame."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-3, 4, (2, 9, 11, 8)).astype(np.int8))
    got = hp.k_concat_dot(x).numpy()
    s = np.pad(x.numpy().astype(np.int32).sum(-1), ((0, 0), (2, 2), (2, 2)))
    want = sum(s[:, ky:ky + 9, kx:kx + 11] for ky in (0, 2, 4) for kx in (0, 2, 4))
    want = np.clip(want, -127, 127)
    assert got.shape == (2, 9, 11, 8)
    np.testing.assert_array_equal(got, np.repeat(want[..., None], 8, axis=-1))


def test_int8_vector_arith_wraps():
    """The script's inputs and its expectation, (int32(a) * 2 + 1) -> int8."""
    a_np = np.arange(8 * 128).astype(np.int8).reshape(8, 128)
    a, b = torch.from_numpy(a_np), torch.ones((8, 128), dtype=torch.int8)
    want = (a_np.astype(np.int32) * 2 + 1).astype(np.int8)
    assert want.min() < 0 < want.max()  # wrapped
    np.testing.assert_array_equal(hp.int8_vector_arith_plain(a, b).numpy(), want)
    np.testing.assert_array_equal(hp.int8_vector_arith(a, b).numpy(), want)
    jn = np.asarray(jnp.asarray(a_np) * jnp.int8(2) + jnp.ones((8, 128), jnp.int8))
    np.testing.assert_array_equal(jn, want)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_grid_scale(n):
    x = torch.ones((n, 8, 128))
    got = hp.grid_scale(x)
    assert got.shape == (n, 8, 128) and np.allclose(got.numpy(), 2.0)
    y = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 8, 128)).astype(
        np.float32))
    np.testing.assert_array_equal(hp.grid_scale_plain(y).numpy(),
                                  np.asarray(jnp.asarray(y.numpy()) * 2.0))


def test_int8_vector_in_grid_shifts_arithmetically():
    x = torch.ones((16, 8, 128), dtype=torch.int8)
    assert bool((hp.int8_vector_in_grid(x) == 2).all())  # the script's check
    full = torch.arange(-128, 128).to(torch.int8).reshape(1, 2, 128).repeat(16, 1, 1)
    want = np.asarray(((jnp.asarray(full.numpy()).astype(jnp.int32) * 3 + 7) >> 2).astype(
        jnp.int8))
    np.testing.assert_array_equal(hp.int8_vector_in_grid_plain(full).numpy(), want)
    assert want[0, 0, 0] == -95  # floor(-377 / 4): a truncating shift gives -94


def test_full_epilogue_takes_packed_weights():
    """Weights packed once by ``pack_qconv_weights``: the same answer as the
    im2col int8 weights they came from, on a ragged frame."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-80, 80, (2, 11, 13, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-90, 90, (9 * 64, 24)).astype(np.int8))
    m = torch.from_numpy(rng.uniform(5e-4, 2e-3, 24).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, 24).astype(np.float32))
    packed = hq.pack_qconv_weights(hp._hwio(w))
    assert packed.dtype == torch.int32 and packed.shape == (9, 16, 24)
    assert hp._hwio(packed) is packed
    want = hp.full_epilogue_plain(x, w, m, b)
    assert 10 < want.float().abs().mean() and want.abs().max() == 127
    assert torch.equal(hp.full_epilogue_plain(x, packed, m, b), want)
    assert torch.equal(hp.full_epilogue(x, packed, m, b), want)


def _offset_view(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` bytes past a 16-byte
    boundary."""
    buf = torch.zeros(t.numel() * t.element_size() + 32, dtype=torch.int8)
    start = (-buf.data_ptr()) % 16 + offset
    view = buf[start:start + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view


@pytest.mark.parametrize("c, offset, kernel", [
    (64, 0, "vec16"), (48, 0, "vec16"), (16, 0, "vec16"), (12, 0, "byte"), (4, 0, "byte"),
    (64, 1, "byte"), (64, 8, "byte"),
])
def test_probe_kernel_for_names_by_channels_and_alignment(c, offset, kernel):
    """The staged probes' rule: the 16-byte kernel takes C a multiple of 16
    on a frame that starts on a 16-byte boundary; the byte-wise one the rest."""
    x = _offset_view(torch.ones((2, 5, 7, c), dtype=torch.int8), offset)
    assert hp.probe_kernel_for(x) == kernel


@pytest.mark.parametrize("offsets, kernel", [((0,), "vec16"), ((0, 0), "vec16"),
                                             ((3,), "byte"), ((0, 4), "byte")])
def test_flat_kernel_for_names_by_alignment(offsets, kernel):
    """The other probes' rule: every operand on a 16-byte boundary, whatever
    its length (the kernel takes a tail), or the byte-wise kernel."""
    ops = [_offset_view(torch.ones((3, 37), dtype=torch.int8), o) for o in offsets]
    assert hp.flat_kernel_for(*ops) == kernel


@pytest.mark.parametrize("name, shape, dtype", [
    ("k_copy", (2, 5, 7, 3), torch.int8), ("k_stage", (1, 8, 8, 12), torch.int8),
    ("k_dyn_read", (1, 8, 8, 12), torch.int8), ("k_reshape", (1, 8, 8, 4), torch.int8),
    ("k_concat_dot", (1, 8, 8, 12), torch.int8), ("int8_vector_arith", (8, 33), torch.int8),
    ("grid_scale", (4, 8, 9), torch.float32), ("int8_vector_in_grid", (4, 8, 9), torch.int8),
])
def test_on_entry_points_refuse_a_kernel_the_rule_does_not_give(name, shape, dtype):
    """``<probe>_on`` takes the rule's kernel or ``"byte"`` and nothing else,
    before it looks at the device; the CPU tensor is then refused, since
    the CPU runs the plain version through the probe itself."""
    on = getattr(hp, name + "_on")
    x = torch.ones(shape, dtype=dtype)
    ops = (x, x) if name == "int8_vector_arith" else (x,)
    if name in ("k_copy", "int8_vector_arith", "grid_scale", "int8_vector_in_grid"):
        ops = tuple(_offset_view(t, 4) for t in ops)  # off 16 bytes: the rule says byte
    ruled = (hp.flat_kernel_for(*ops) if len(shape) != 4 or name == "k_copy"
             else hp.probe_kernel_for(*ops))
    assert ruled == "byte"
    for wrong in ("vec16", "mma", "dp4a"):
        with pytest.raises(ValueError, match="does not take"):
            on(wrong, *ops)
    with pytest.raises(ValueError, match="CUDA tensor"):
        on("byte", *ops)
    assert torch.equal(getattr(hp, name)(*ops), getattr(hp, name + "_plain")(*ops))


def test_probe_counters_count_by_kernel():
    """Every probe counts its launches by kernel, one key a kernel of
    ``csrc/probes.cu``, summing to its total."""
    for fn in hp.PROBES:
        assert set(fn.launches_by_kernel) == set(hp.KERNEL_CODES) == {"byte", "vec16"}
        assert fn.launches == sum(fn.launches_by_kernel.values())
