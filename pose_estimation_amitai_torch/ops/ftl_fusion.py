"""The middle of the 4-camera disentanglement model as one serving op.

``FourCamDisentangled`` (models/disentangled.py; reference:
pytorch/CNNs.py:240-352) runs, between its shared per-view encoder and its
shared decoder,

    r_v   = rearrange1(e_v)                    1x1, 256 -> 3G
    c_v   = FTL^-1(r_v, P_inv_v)               groups of 3 -> 4, float32
    f     = ReLU(bn1(fusion1([c_0 .. c_3])))   1x1, 16G -> 4G
    f     = ReLU(bn2(fusion2(f)))              1x1, 4G -> 4G
    t_v   = ReLU(bn3(FTL(f, P_v)))             groups of 4 -> 3, float32
    out_v = rearrange2(t_v) + e_v              1x1, 3G -> 256, the skip

for each view v of a sample, with that sample's own cameras ``P`` (4, 3, 4)
and ``P_inv`` (4, 4, 3), the BatchNorms on their running averages, the
channels of each pixel grouped per pixel (the registry's layout). The op
takes the four views' encoder outputs as view-rows, (4B, h, w, 256) NHWC,
sample-major (row 4b + v), and returns the decoder's input in the same
layout and dtype. Numerics are the module route's: the 1x1s in the latent's
dtype (float32 accumulation, rounded once with their bias), the FTLs and
BatchNorms in float32, rounded to the latent's dtype where the module rounds.

Three versions of the same arithmetic, picked by :func:`ftl_path_for`:
``"plain"``, the module's ops in their order (a loop over the views, the
FTLs as einsums over per-pixel groups); ``"wgmma"``, one hand-written kernel
(ops/hopper_ftl.py, csrc/ftl_fusion.cu) for bfloat16 latents on the card at
the widths it takes, every intermediate in registers and shared memory; and
``"gemm"``, for the other latents on the card (float32, other widths), the
same on channels-last rows with no NCHW permute: the 1x1s as GEMMs over every
pixel of the chunk, each FTL as one batched per-sample product on a (rows,
pixels x G, 3 or 4) view. Each run of ``"gemm"`` adds one to
``ftl_fusion.launches``, each of ``"wgmma"`` one to
``hopper_ftl.ftl_fusion_kernel.launches``.

Weights: each 1x1 as a (Cin, Cout) matrix and a (Cout,) bias in the
latent's dtype (the module's bias is a parameter of that dtype); each
BatchNorm as a (4, C) float32 stack of scale, bias, running mean and running
variance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import hopper_ftl

VIEWS = 4
GEMM_DTYPES = (torch.bfloat16, torch.float32)


def ftl_path_for(device: torch.device, dtype: torch.dtype, width: int, latent: int) -> str:
    """The version a latent of this device, dtype, encoder width and latent
    width (rearrange1's output) runs: ``"wgmma"`` for CUDA latents the
    kernel takes (:func:`hopper_ftl.ftl_kernel_takes`: bfloat16 at its
    widths), ``"gemm"`` for the other CUDA latents of bfloat16 or float32,
    ``"plain"`` for every other latent (CPU tensors, other dtypes)."""
    if device.type != "cuda" or dtype not in GEMM_DTYPES:
        return "plain"
    return "wgmma" if hopper_ftl.ftl_kernel_takes(dtype, width, latent) else "gemm"


def _batch_norm(x: torch.Tensor, bn: torch.Tensor, eps: float) -> torch.Tensor:
    """models/norm.py ``BatchNorm`` on its running averages over the last
    axis of ``x``, in float32, in its order of operations."""
    scale, bias, mean, var = bn
    mul = torch.rsqrt(var + eps) * scale
    return (x.float() - mean) * mul + bias


def check_operands(latent, P, P_inv, w_r1, w_f1, w_f2, w_r2, bn1, bn2, bn3) -> None:
    """Raise ``ValueError`` unless the shapes agree with one another."""
    if latent.dim() != 4 or latent.shape[0] % VIEWS:
        raise ValueError(f"latent {tuple(latent.shape)}: expected (4B, h, w, C) view-rows")
    n4, _, _, c = latent.shape
    b = n4 // VIEWS
    lat3 = w_r1.shape[1]
    canon = lat3 // 3 * 4
    want = {"P": (P, (b, VIEWS, 3, 4)), "P_inv": (P_inv, (b, VIEWS, 4, 3)),
            "w_r1": (w_r1, (c, lat3)), "w_f1": (w_f1, (VIEWS * canon, canon)),
            "w_f2": (w_f2, (canon, canon)), "w_r2": (w_r2, (lat3, c)),
            "bn1": (bn1, (4, canon)), "bn2": (bn2, (4, canon)), "bn3": (bn3, (4, lat3))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    if lat3 % 3:
        raise ValueError(f"latent width {lat3} is not whole groups of 3")


def ftl_fusion_plain(
    latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2, bn1, bn2, bn3, eps,
) -> torch.Tensor:
    """The module's ops in its order, view by view, on NHWC rows."""
    n4, h, w, c = latent.shape
    b = n4 // VIEWS
    dt = latent.dtype
    views = latent.view(b, VIEWS, h, w, c)

    def ftl(t: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """Groups of ``cam``'s columns through each sample's ``cam``, float32."""
        i, j = cam.shape[-2:]
        z = t.float().reshape(b, h, w, t.shape[-1] // j, j)
        out = torch.einsum("bhwgj,bij->bhwgi", z, cam.float())
        return out.reshape(b, h, w, -1)

    canonical = [ftl(F.linear(views[:, v], w_r1.mT, b_r1), P_inv[:, v]).to(dt)
                 for v in range(VIEWS)]
    f = F.relu(_batch_norm(F.linear(torch.cat(canonical, dim=-1), w_f1.mT, b_f1), bn1, eps))
    f = F.relu(_batch_norm(F.linear(f.to(dt), w_f2.mT, b_f2), bn2, eps))
    outs = []
    for v in range(VIEWS):
        t = F.relu(_batch_norm(ftl(f, P[:, v]), bn3, eps)).to(dt)
        outs.append(F.linear(t, w_r2.mT, b_r2) + views[:, v])
    return torch.stack(outs, dim=1).view(n4, h, w, c)


def ftl_fusion_gemm(
    latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2, bn1, bn2, bn3, eps,
) -> torch.Tensor:
    """The same arithmetic on channels-last rows: each 1x1 one GEMM over
    every pixel of the chunk, each FTL one batched product per view-row or
    sample on its (pixels x G, 3 or 4) groups, the views brought side by side
    for ``fusion1`` and apart for ``rearrange2`` by one copy each."""
    n4, h, w, c = latent.shape
    b, pix = n4 // VIEWS, h * w
    dt = latent.dtype
    g = w_r1.shape[1] // 3
    x = latent.reshape(n4 * pix, c)
    r = torch.addmm(b_r1, x, w_r1).float()  # (4B pix, 3G)
    # FTL^-1: each view-row's groups of 3 through its (4, 3) P_inv, float32
    canon = torch.bmm(r.view(n4, pix * g, 3), P_inv.reshape(n4, 4, 3).mT).to(dt)
    # the four views' canonical channels side by side, per sample and pixel
    side = canon.view(b, VIEWS, pix, 4 * g).transpose(1, 2).reshape(b * pix, VIEWS * 4 * g)
    f = F.relu(_batch_norm(torch.addmm(b_f1, side, w_f1), bn1, eps)).to(dt)
    f = F.relu(_batch_norm(torch.addmm(b_f2, f, w_f2), bn2, eps))  # float32, as the FTL takes it
    # FTL: each pixel's groups of 4 through the sample's four (3, 4) P at
    # once, (B, pix G, 4) @ (B, 4, 4 x 3): channel (g, v, i)
    t = torch.bmm(f.view(b, pix * g, 4), P.reshape(b, VIEWS * 3, 4).mT)
    t = t.view(b, pix, g, VIEWS, 3).permute(0, 3, 1, 2, 4).reshape(n4 * pix, 3 * g)
    t = F.relu(_batch_norm(t, bn3, eps)).to(dt)
    return torch.addmm(b_r2, t, w_r2).add_(x).view(n4, h, w, c)


def ftl_fusion(
    latent: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor,
    w_r1: torch.Tensor, b_r1: torch.Tensor, w_f1: torch.Tensor, b_f1: torch.Tensor,
    w_f2: torch.Tensor, b_f2: torch.Tensor, w_r2: torch.Tensor, b_r2: torch.Tensor,
    bn1: torch.Tensor, bn2: torch.Tensor, bn3: torch.Tensor, eps: float,
) -> torch.Tensor:
    """(4B, h, w, C) view-rows of encoder outputs -> the decoder's (4B, h, w,
    C) input, on the path :func:`ftl_path_for` names."""
    check_operands(latent, P, P_inv, w_r1, w_f1, w_f2, w_r2, bn1, bn2, bn3)
    args = (latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2, bn1, bn2, bn3,
            eps)
    path = ftl_path_for(latent.device, latent.dtype, latent.shape[-1], w_r1.shape[1])
    if path == "plain":
        return ftl_fusion_plain(*args)
    if path == "wgmma":
        return hopper_ftl.ftl_fusion_kernel(*args)
    out = ftl_fusion_gemm(*args)
    ftl_fusion.launches += 1
    return out


ftl_fusion.launches = 0
