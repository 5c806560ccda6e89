"""Expert parallelism: a top-1 mixture-of-experts FFN over an ``expert``
axis (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/parallel/expert.py``. The E
experts' parameters are stacked on a leading axis and split over
``expert``, each process holding E / ep of them; the gate replicates.
Routing is the dense dispatch of JAX's: each process runs its experts over
every token, weights their outputs by the gate (zero for the tokens routed
elsewhere) and one sum over ``expert`` combines them, exactly the
unsharded MoE (no capacity factor, no dropped tokens). Top-1 ties go to the
first expert, as ``jnp.argmax`` and ``torch.argmax`` both give them; GELU
is the tanh form, ``jax.nn.gelu``'s default.

The tokens and the gate enter through ``share_input`` (each process uses
its own part of them, so their cotangents are summed over ``expert``), and
the combine is ``psum_replicated`` (every process computes the same loss
from it): the gradients are the dense MoE's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import axis_index, axis_size, make_2d_mesh, psum_replicated, share_input, shard_params

EXPERT_AXIS = "expert"
EXPERT_KEYS = ("w1", "b1", "w2", "b2")


def make_expert_mesh(dp: int, ep: int, device: torch.device | str = "cuda"):
    """A ``(data, expert)`` mesh."""
    return make_2d_mesh(dp, ep, EXPERT_AXIS, device)


class MoEFeedForward:
    """Top-1-gated MoE FFN (Linear -> GELU -> Linear per expert): (B, N, D)
    tokens -> (B, N, D). ``apply_dense`` is the unsharded function;
    ``apply`` runs expert-parallel over the mesh on the parameters of
    :meth:`shard_params`. Parameters: ``gate`` (D, E), ``w1`` (E, D, H),
    ``b1`` (E, H), ``w2`` (E, H, D), ``b2`` (E, D), JAX's layout."""

    def __init__(self, mesh, *, dim: int, hidden_dim: int, num_experts: int):
        self.mesh = mesh
        self.ep = axis_size(mesh, EXPERT_AXIS)
        if num_experts % self.ep:
            raise ValueError(f"{num_experts} experts must divide over {self.ep} shards")
        self.dim, self.hidden, self.num_experts = dim, hidden_dim, num_experts

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Normal kernels scaled as JAX's (gate D^-1/2, w1 (2/D)^1/2, w2
        (2/H)^1/2), zero biases, float32 on the generator's device."""
        d, h, e = self.dim, self.hidden, self.num_experts
        dev = generator.device

        def normal(shape, std):
            return torch.randn(shape, generator=generator, device=dev) * std

        return {"gate": normal((d, e), d ** -0.5),
                "w1": normal((e, d, h), (2.0 / d) ** 0.5),
                "b1": torch.zeros((e, h), device=dev),
                "w2": normal((e, h, d), (2.0 / h) ** 0.5),
                "b2": torch.zeros((e, d), device=dev)}

    def shard_params(self, params: dict) -> dict:
        """The first process's parameters on every process, then this
        process's E / ep experts of each stack."""
        params = shard_params(self.mesh, params)
        le, i = self.num_experts // self.ep, axis_index(self.mesh, EXPERT_AXIS)
        return {k: v[i * le : (i + 1) * le] if k in EXPERT_KEYS else v
                for k, v in params.items()}

    def _gates(self, gate_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Top-1 gate weights (B, N, E): the softmax probability at the
        argmax expert, zero elsewhere."""
        logits = torch.einsum("bnd,de->bne", x, gate_w)
        probs = torch.softmax(logits, dim=-1)
        hot = F.one_hot(logits.argmax(dim=-1), self.num_experts).to(probs.dtype)
        return probs * hot

    @staticmethod
    def _expert_ffn(w1, b1, w2, b2, x: torch.Tensor) -> torch.Tensor:
        """Every expert given over every token: (e, B, N, D)."""
        h = torch.einsum("bnd,edh->ebnh", x, w1) + b1[:, None, None, :]
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("ebnh,ehd->ebnd", h, w2) + b2[:, None, None, :]

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Expert-parallel forward: ``x`` this process's (B, N, D) rows."""
        group = self.mesh.get_group(EXPERT_AXIS)
        le, i = self.num_experts // self.ep, axis_index(self.mesh, EXPERT_AXIS)
        x = share_input(x, group)
        gates = self._gates(share_input(params["gate"], group), x)[..., i * le : (i + 1) * le]
        y = self._expert_ffn(*(params[k] for k in EXPERT_KEYS), x)
        return psum_replicated(torch.einsum("bne,ebnd->bnd", gates, y), group)

    def apply_dense(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The unsharded function on one process (all E experts)."""
        y = self._expert_ffn(*(params[k] for k in EXPERT_KEYS), x)
        return torch.einsum("bne,ebnd->bnd", self._gates(params["gate"], x), y)
