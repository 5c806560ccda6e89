"""Ring attention (parallel/sequence.py) in a 4-rank gloo world on the CPU,
at (data 1, seq 4) and (data 2, seq 2), (B 2, N 32, H 2, D 8): the output
against ``reference_attention`` and against JAX's ``ring_attention`` on the
same meshes in float32 within 1e-5, the gradients of q, k and v against
the reference's within 1e-5 of their largest, and bf16 inputs within JAX's
bf16 bound (atol 3e-2, tests/test_sequence_parallel.py)."""

import numpy as np
import pytest
import torch

from pose_estimation_amitai_torch.parallel.mesh import axis_index
from pose_estimation_amitai_torch.parallel.sequence import (
    SEQ_AXIS,
    make_seq_mesh,
    reference_attention,
    ring_attention,
)

from test_torch_parallel_mesh import World

B, N, H, D = 2, 32, 2, 8
MESHES = ((1, 4), (2, 2))


def _qkvw(dtype=np.float32):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, N, H, D)).astype(dtype) for _ in range(4)]


def _slab(x: np.ndarray, dp: int, sp: int, i: int, j: int) -> np.ndarray:
    b, n = B // dp, N // sp
    return x[i * b : (i + 1) * b, j * n : (j + 1) * n]


def _seq_body(rank, world):
    res = {}
    q, k, v, w = _qkvw()
    for dp, sp in MESHES:
        mesh = make_seq_mesh(dp, sp, "cpu")
        i, j = axis_index(mesh, "data"), axis_index(mesh, SEQ_AXIS)
        live = [torch.from_numpy(_slab(a, dp, sp, i, j)).requires_grad_() for a in (q, k, v)]
        out = ring_attention(*live, mesh)
        (out * torch.from_numpy(_slab(w, dp, sp, i, j))).sum().backward()
        res[(dp, sp)] = (i, j, out.detach().numpy(), [t.grad.numpy() for t in live])
        bf = [torch.from_numpy(_slab(a, dp, sp, i, j)).bfloat16() for a in (q, k, v)]
        out_bf = ring_attention(*bf, mesh)
        res[(dp, sp, "bf16")] = (out_bf.dtype, out_bf.float().numpy())
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(_seq_body, 4, tmp_path_factory.mktemp("seq"))


def _assemble(world_results, key, pick):
    dp, sp = key
    out = np.zeros((B, N, H, D), np.float32)
    for res in world_results:
        i, j = res[key][0], res[key][1]
        out[i * (B // dp) : (i + 1) * (B // dp), j * (N // sp) : (j + 1) * (N // sp)] = pick(res)
    return out


@pytest.fixture(scope="module")
def jax_ring(world):
    """JAX's ring_attention on the virtual CPU mesh, float32 and bf16."""
    import jax
    import jax.numpy as jnp
    from pose_estimation_amitai_tpu.parallel import sequence as jseq

    q, k, v, _ = _qkvw()
    out = {}
    for dp, sp in MESHES:
        mesh = jseq.make_seq_mesh(dp=dp, sp=sp)
        fn = jax.jit(lambda *a, m=mesh: jseq.ring_attention(*a, mesh=m))
        out[(dp, sp)] = np.asarray(fn(q, k, v))
        out[(dp, sp, "bf16")] = np.asarray(
            fn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))), np.float32)
    return out


@pytest.fixture(scope="module")
def seq_world(world, jax_ring):
    return world.results()


def _reference():
    q, k, v, w = _qkvw()
    live = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = reference_attention(*live)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in live]


@pytest.mark.parametrize("mesh", MESHES)
def test_ring_attention_matches_reference_and_jax(seq_world, jax_ring, mesh):
    want, want_grads = _reference()
    got = _assemble(seq_world, mesh, lambda r: r[mesh][2])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jax_ring[mesh], rtol=0, atol=1e-5)
    for n, g in enumerate(want_grads):
        mine = _assemble(seq_world, mesh, lambda r, n=n: r[mesh][3][n])
        np.testing.assert_allclose(mine, g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg="qkv"[n])


@pytest.mark.parametrize("mesh", MESHES)
def test_ring_attention_bf16_inputs(seq_world, jax_ring, mesh):
    q, k, v, _ = _qkvw()
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    want = reference_attention(*bf).float().numpy()
    key = (*mesh, "bf16")
    assert all(r[key][0] == torch.bfloat16 for r in seq_world)
    got = _assemble(seq_world, mesh, lambda r: r[key][1])
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
    np.testing.assert_allclose(got, jax_ring[key], rtol=0, atol=3e-2)
