"""Sequence parallelism: ring attention over a ``seq`` axis (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/sequence.py``. Each of
the S processes of a ``seq`` line holds one slab of N / S tokens of q, k
and v. S - 1 ticks each fold the visiting k/v slab into a float32 online
softmax (running row max ``m``, normaliser ``l``, unnormalised output
``o``: no N x N logits) and pass the slab one hop along the ring
(``ppermute``); the last slab is folded without the hop, whose result
nobody would read. The output is cast back to q's dtype. Gradients flow
through the reversed ring (``ppermute``'s backward).

The fold stays in plain PyTorch, as JAX keeps it in einsums: the port's
attention kernel (ops/hopper_attention.py) computes a whole softmax, not
the (o, l, m) fold. Bidirectional, no mask: the ViT's attention.
"""

from __future__ import annotations

import torch

from .mesh import axis_size, make_2d_mesh, ppermute

SEQ_AXIS = "seq"


def make_seq_mesh(dp: int, sp: int, device: torch.device | str = "cuda"):
    """A ``(data, seq)`` mesh: data parallelism over rows, the ring over
    columns."""
    return make_2d_mesh(dp, sp, SEQ_AXIS, device)


def _fold(qf, o, l, m, kc, vc, scale):
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kc.float()) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhnm,bmhd->bhnd", p, vc.float())
    return o, l, m_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D)) v`` over the whole sequence, sharded over
    ``seq``: q, k, v are this process's (B, n, H, D) slab (its rows of the
    batch where the mesh has ``data``, its block of n = N / S tokens in
    ``seq`` order); returns the output's slab in q's dtype."""
    group, sp = mesh.get_group(SEQ_AXIS), axis_size(mesh, SEQ_AXIS)
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    b, n, h, d = qf.shape
    o = qf.new_zeros((b, h, n, d))
    l = qf.new_zeros((b, h, n))
    m = qf.new_full((b, h, n), float("-inf"))
    kc, vc = k, v
    for _ in range(sp - 1):
        o, l, m = _fold(qf, o, l, m, kc, vc, scale)
        kc, vc = ppermute(kc, group), ppermute(vc, group)
    o, l, _ = _fold(qf, o, l, m, kc, vc, scale)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention on one process, for equivalence checks."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", a, v.float()).to(q.dtype)
