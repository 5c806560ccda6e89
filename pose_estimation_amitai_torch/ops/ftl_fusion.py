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

Two versions of the same arithmetic, picked by :func:`ftl_path_for`:
``"plain"``, the module's ops in their order (a loop over the views, the
FTLs as einsums over per-pixel groups), and ``"gemm"``, the same on
channels-last rows with no NCHW permute: the 1x1s as GEMMs over every pixel
of the chunk, each FTL as one batched per-sample product on a (rows,
pixels x G, 3 or 4) view, the views brought side by side for ``fusion1`` by
one cast-and-permute copy and apart for ``rearrange2`` by ``bn3``'s pass,
which writes its output permuted. Each run of ``"gemm"`` adds one to
``ftl_fusion.launches``.

Weights: each 1x1 as a (Cin, Cout) matrix and a (Cout,) bias in the
latent's dtype (the module's bias is a parameter of that dtype); each
BatchNorm as a (4, C) float32 stack of scale, bias, running mean and running
variance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VIEWS = 4
GEMM_DTYPES = (torch.bfloat16, torch.float32)
ALIGN = 8  # "gemm": GEMM operand widths padded to a multiple of 8 elements
INV_GROUPS = 8  # "gemm": groups of 3 a row of the inverse FTL's product (H100: 2.4x)
FWD_GROUPS = 2  # "gemm": groups of 4 a row of the FTL's product (H100: 1.6x)


def ftl_path_for(device: torch.device, dtype: torch.dtype) -> str:
    """``"gemm"`` for CUDA latents of bfloat16 or float32; ``"plain"`` for
    every other latent (CPU tensors, other dtypes)."""
    return "gemm" if device.type == "cuda" and dtype in GEMM_DTYPES else "plain"


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


def _scale_shift(bn: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A BatchNorm stack as the product and sum of ``x * mul + shift``."""
    scale, bias, mean, var = bn
    mul = torch.rsqrt(var + eps) * scale
    return mul, bias - mean * mul


def _kron(cam: torch.Tensor, k: int) -> torch.Tensor:
    """(n, i, j) cameras -> (n, k j, k i): each camera once for each of k
    groups of a row, kron(I_k, cam^T), so that one product takes k groups;
    the products it adds are exact zeros, and the sums are the same."""
    n, i, j = cam.shape
    eye = torch.eye(k, dtype=cam.dtype, device=cam.device)
    return torch.einsum("qp,bij->bqjpi", eye, cam).reshape(n, k * j, k * i)


def ftl_fusion_gemm(
    latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2, bn1, bn2, bn3, eps,
) -> torch.Tensor:
    """The same arithmetic on channels-last rows: GEMMs over the chunk's
    pixels (the 3G-wide operands padded with zero columns to a multiple of
    ``ALIGN``, so that cuBLAS reads 16-byte rows), each FTL one batched
    product per view-row or sample (``INV_GROUPS`` and ``FWD_GROUPS`` groups
    a row of it), each BatchNorm one ``x * mul + shift`` pass in float32
    (ReLU after it in place; rounded where it is stored in the latent's
    dtype, which ReLU commutes with)."""
    n4, h, w, c = latent.shape
    b, pix = n4 // VIEWS, h * w
    dt, dev = latent.dtype, latent.device
    lat3 = w_r1.shape[1]
    g, pad = lat3 // 3, -lat3 % ALIGN
    x = latent.reshape(n4 * pix, c)
    r = torch.addmm(F.pad(b_r1, (0, pad)), x, F.pad(w_r1, (0, pad)))  # (4B pix, 3G + pad)
    z = torch.empty((n4 * pix, lat3), dtype=torch.float32, device=dev)
    z.copy_(r[:, :lat3])
    # FTL^-1: each view-row's groups of 3 through its (4, 3) P_inv, float32
    k = math.gcd(pix * g, INV_GROUPS)
    canon = torch.bmm(z.view(n4, pix * g // k, 3 * k), _kron(P_inv.reshape(n4, 4, 3), k))
    # the four views' canonical channels side by side, per sample and pixel
    side = torch.empty((b, pix, VIEWS, 4 * g), dtype=dt, device=dev)
    side.copy_(canon.view(b, VIEWS, pix, 4 * g).transpose(1, 2))
    f = torch.addmm(b_f1, side.view(b * pix, -1), w_f1)
    mul, shift = _scale_shift(bn1, eps)
    f = torch.addcmul(shift, f, mul, out=torch.empty_like(f)).relu_()  # fusion2 takes dt
    f = torch.addmm(b_f2, f, w_f2)
    mul, shift = _scale_shift(bn2, eps)
    f = torch.addcmul(shift, f, mul).relu_()  # float32, as the FTL takes it
    # FTL: each pixel's groups of 4 through the sample's four (3, 4) P at
    # once, (B, pix G, 4) @ (B, 4, 4 x 3): channel (g, v, i)
    k = math.gcd(pix * g, FWD_GROUPS)
    t = torch.bmm(f.view(b, pix * g // k, 4 * k), _kron(P.reshape(b, VIEWS * 3, 4), k))
    mul, shift = (a.view(g, 1, 3) for a in _scale_shift(bn3, eps))
    apart = torch.empty((b, VIEWS, pix, lat3 + pad), dtype=dt, device=dev)
    apart[..., lat3:].zero_()
    torch.addcmul(shift, t.view(b, pix, g, VIEWS, 3), mul,
                  out=apart[..., :lat3].view(b, VIEWS, pix, g, 3).permute(0, 2, 3, 1, 4))
    out = torch.addmm(b_r2, apart.relu_().view(n4 * pix, -1), F.pad(w_r2, (0, 0, 0, pad)))
    return out.add_(x).view(n4, h, w, c)


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
    if ftl_path_for(latent.device, latent.dtype) == "plain":
        return ftl_fusion_plain(*args)
    out = ftl_fusion_gemm(*args)
    ftl_fusion.launches += 1
    return out


ftl_fusion.launches = 0
