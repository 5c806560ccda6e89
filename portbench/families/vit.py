"""The torch-flavour ``ViTPoseNet`` (reference: pytorch/VITs.py:13-229,
pytorch/pytorch_vit_encoder.py): a stride-p patch conv, LayerNorm, a
learned positional embedding; ``depth`` pre-LN blocks of multi-head
attention (fused qkv without bias, softmax of q k^T / sqrt(dim_head)) and
a GELU (tanh form) MLP, each added back; a final LayerNorm; the token grid
through four stride-2 transposed convs (the reference's ``padding=1,
output_padding=1`` crop, flax pads (k - 2, k - 1)), LeakyReLU 0.1 on each;
each sample's maps min-max normalised over all positions and channels.
LayerNorm epsilon 1e-6 (flax's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import work
from . import conv_transpose, leaky

VAL_MODE = "minmax"  # the served val is the min-max normalised map's value
LN_EPS = 1e-6


def _dims(spec: dict) -> dict:
    h, _, c = spec["image_shape"]
    p = spec["patch_size"]
    dim, heads = spec["dim"], spec["heads"]
    dh = spec["dim_head"]
    return dict(c=c, p=p, g=h // p, n=(h // p) ** 2, dim=dim, heads=heads, dh=dh,
                inner=heads * dh, mlp=dim * spec["mlp_expand"], depth=spec["depth"],
                k=spec["kernel_size"], out=spec["out_channels"])


def leaves(spec: dict) -> list[tuple[str, tuple, str, int]]:
    d = _dims(spec)
    dim, k = d["dim"], d["k"]
    out = [("patch_embed/proj/kernel", (d["p"], d["p"], d["c"], dim), "kernel",
            d["p"] * d["p"] * d["c"]),
           ("patch_embed/proj/bias", (dim,), "bias", 0),
           ("patch_embed/pos_embedding", (1, d["n"], dim), "embed", 0),
           ("patch_embed/embed_norm/scale", (dim,), "scale", 0),
           ("patch_embed/embed_norm/bias", (dim,), "shift", 0)]
    for i in range(d["depth"]):
        a, f = f"transformer/attn{i}", f"transformer/ff{i}"
        out += [(f"{a}/norm/scale", (dim,), "scale", 0), (f"{a}/norm/bias", (dim,), "shift", 0),
                (f"{a}/to_qkv/kernel", (dim, 3 * d["inner"]), "kernel", dim),
                (f"{a}/to_out/kernel", (d["inner"], dim), "kernel", d["inner"]),
                (f"{a}/to_out/bias", (dim,), "bias", 0),
                (f"{f}/norm/scale", (dim,), "scale", 0), (f"{f}/norm/bias", (dim,), "shift", 0),
                (f"{f}/fc1/kernel", (dim, d["mlp"]), "kernel", dim),
                (f"{f}/fc1/bias", (d["mlp"],), "bias", 0),
                (f"{f}/fc2/kernel", (d["mlp"], dim), "kernel", d["mlp"]),
                (f"{f}/fc2/bias", (dim,), "bias", 0)]
    out += [("transformer/final_norm/scale", (dim,), "scale", 0),
            ("transformer/final_norm/bias", (dim,), "shift", 0)]
    for i, co in enumerate((dim, dim, dim, d["out"]), 1):
        out += [(f"decoder/deconv{i}/kernel", (k, k, dim, co), "kernel", k * k * dim),
                (f"decoder/deconv{i}/bias", (co,), "bias", 0)]
    return out


def _ln(x: torch.Tensor, p: dict, scope: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{scope}/scale"], p[f"{scope}/bias"], LN_EPS)


def _dense(x: torch.Tensor, p: dict, scope: str, quant, bias: bool = True) -> torch.Tensor:
    y = quant(x) @ quant(p[f"{scope}/kernel"])
    return y + p[f"{scope}/bias"] if bias else y


def forward(p: dict, frames: torch.Tensor, spec: dict, quant=lambda t: t,
            gen: torch.Generator | None = None, rate: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) float32 frames -> (B, H, W, K) float32 maps, each
    sample min-max normalised. Serving only (``rate`` must be 0)."""
    if rate:
        raise ValueError("the ViT reference serves only")
    d = _dims(spec)
    b = frames.shape[0]
    g, pp, c = d["g"], d["p"], d["c"]
    patches = frames[:, : g * pp, : g * pp].reshape(b, g, pp, g, pp, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, pp * pp * c)
    kern = p["patch_embed/proj/kernel"].reshape(pp * pp * c, d["dim"])
    x = quant(patches) @ quant(kern) + p["patch_embed/proj/bias"]
    x = _ln(x, p, "patch_embed/embed_norm") + p["patch_embed/pos_embedding"]
    h, dh = d["heads"], d["dh"]
    for i in range(d["depth"]):
        a, f = f"transformer/attn{i}", f"transformer/ff{i}"
        y = _ln(x, p, f"{a}/norm")
        qkv = _dense(y, p, f"{a}/to_qkv", quant, bias=False).view(b, d["n"], 3, h, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bnhd,bmhd->bhnm", quant(q), quant(k)) * dh ** -0.5
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhnm,bmhd->bnhd", quant(attn), quant(v)).reshape(b, d["n"], h * dh)
        x = x + _dense(o, p, f"{a}/to_out", quant)
        y = _ln(x, p, f"{f}/norm")
        y = F.gelu(_dense(y, p, f"{f}/fc1", quant), approximate="tanh")
        x = x + _dense(y, p, f"{f}/fc2", quant)
    x = _ln(x, p, "transformer/final_norm")
    x = x.reshape(b, g, g, d["dim"]).permute(0, 3, 1, 2)
    k = d["k"]
    for i in range(1, 5):
        x = leaky(conv_transpose(x, p[f"decoder/deconv{i}/kernel"], p[f"decoder/deconv{i}/bias"],
                                 2, (k - 2, k - 1), quant))
    x = x.permute(0, 2, 3, 1)
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo + 1e-12)


def flops_per_frame(spec: dict) -> float:
    """2 x multiply-adds of one frame's forward: patch conv, every block's
    four products and two attention products, the four transposed convs."""
    d = _dims(spec)
    n, dim = d["n"], d["dim"]
    total = work.matmul_ops(n, d["p"] * d["p"] * d["c"], dim)
    per_block = (work.matmul_ops(n, dim, 3 * d["inner"])
                 + 2 * d["heads"] * work.matmul_ops(n, d["dh"], n)
                 + work.matmul_ops(n, d["inner"], dim)
                 + work.matmul_ops(n, dim, d["mlp"]) + work.matmul_ops(n, d["mlp"], dim))
    total += d["depth"] * per_block
    px = n
    for co in (dim, dim, dim, d["out"]):
        total += work.deconv_ops(px, d["k"], dim, co)
        px *= 4
    return total


def kernel_bounds(spec: dict, rows: int) -> dict[str, list[float]]:
    """Bound seconds of each attention-core call of one chunk's forward on
    the ``fused`` route (one a block), at ``rows`` frames: q k^T and the
    product with v at the bf16 peak, or the packed qkv read and the output
    written once at the memory peak."""
    if spec["route"] != "fused":
        return {}
    d = _dims(spec)
    act = work.DTYPE_BYTES[spec["dtype"]]
    ops = 4.0 * rows * d["heads"] * d["n"] ** 2 * d["dh"]
    moved = 4 * rows * d["n"] * d["heads"] * d["dh"] * act
    return {"pose_estimation::fused_attention": [work.bound_s(ops, moved)] * d["depth"]}
