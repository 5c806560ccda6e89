"""The torch-flavour ``BasicNet`` (reference: pytorch/CNNs.py:9-186):
three stages of three dilated 3x3 convs at ``filters``, 2x and 4x with
residual skips between consecutive convs, 2x2 max-pool and LeakyReLU 0.1
after the first two stages; then a transposed-conv decoder, stride 2, 1,
1, 2 (the first and last with the reference's ``padding=1,
output_padding=1``, flax pads (k - 2, k - 1)), skips around the two
stride-1 layers, LeakyReLU 0.1 on every layer. NHWC frames in, NHWC maps
out. In training, dropout after each stage.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import work
from . import conv_same, conv_transpose, dropout, leaky

VAL_MODE = "raw"  # the served val is the map's value at the peak


def _widths(spec: dict) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    f, cin, k_out = spec["filters"], spec["image_shape"][2], spec["out_channels"]
    enc, c = [], cin
    for mult in (1, 2, 4):
        for i in range(3):
            enc.append((c, f * mult))
            c = f * mult
    dec = [(c, c // 2), (c // 2, c // 2), (c // 2, c // 2), (c // 2, k_out)]
    return enc, dec


def leaves(spec: dict) -> list[tuple[str, tuple, str, int]]:
    k = spec["kernel_size"]
    enc, dec = _widths(spec)
    out = []
    for i, (ci, co) in enumerate(enc, 1):
        out += [(f"encoder/conv{i}/kernel", (k, k, ci, co), "kernel", k * k * ci),
                (f"encoder/conv{i}/bias", (co,), "bias", 0)]
    for i, (ci, co) in enumerate(dec, 1):
        out += [(f"decoder/deconv{i}/kernel", (k, k, ci, co), "kernel", k * k * ci),
                (f"decoder/deconv{i}/bias", (co,), "bias", 0)]
    return out


def flax_leaf(path: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf of the program's torch modules in flax's layout: a conv's
    OIHW weight as HWIO; a transposed conv's (I, O, kh, kw) weight, which
    ``conv_transpose2d`` applies turned by 180 degrees, as flax's unturned
    HWIO kernel."""
    if not path.endswith("/kernel"):
        return t
    if path.startswith("decoder/"):
        return t.permute(2, 3, 0, 1).flip(0, 1)
    return t.permute(2, 3, 1, 0)


def forward(p: dict, frames: torch.Tensor, spec: dict, quant=lambda t: t,
            gen: torch.Generator | None = None, rate: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) float32 frames -> (B, H, W, K) float32 maps."""
    dil, k = spec["dilation"], spec["kernel_size"]
    x = frames.permute(0, 3, 1, 2)
    for stage in range(3):
        c = [(p[f"encoder/conv{3 * stage + i}/kernel"], p[f"encoder/conv{3 * stage + i}/bias"])
             for i in (1, 2, 3)]
        x1 = leaky(conv_same(x, *c[0], dil, quant))
        x2 = leaky(conv_same(x1, *c[1], dil, quant)) + x1
        x3 = leaky(conv_same(x2, *c[2], dil, quant)) + x2
        if stage < 2:
            x3 = leaky(F.max_pool2d(x3, 2, 2))
        x = dropout(x3, rate, gen)
    d = [(p[f"decoder/deconv{i}/kernel"], p[f"decoder/deconv{i}/bias"]) for i in (1, 2, 3, 4)]
    # stride 2: the reference's crop; stride 1: flax's SAME, the odd pad low
    up, same = (k - 2, k - 1), (k // 2, (k - 1) - k // 2)
    y1 = leaky(conv_transpose(x, *d[0], 2, up, quant))
    y2 = leaky(conv_transpose(y1, *d[1], 1, same, quant)) + y1
    y3 = leaky(conv_transpose(y2, *d[2], 1, same, quant)) + y2
    y = leaky(conv_transpose(y3, *d[3], 2, up, quant))
    return y.permute(0, 2, 3, 1)


def flops_per_frame(spec: dict) -> float:
    """2 x multiply-adds of one frame's forward."""
    h, w = spec["image_shape"][:2]
    k = spec["kernel_size"]
    enc, dec = _widths(spec)
    total = 0.0
    for i, (ci, co) in enumerate(enc):
        scale = 2 ** (i // 3)  # stages run at full, half and quarter size
        total += work.conv_ops((h // scale) * (w // scale), k, ci, co)
    lat = (h // 4) * (w // 4)
    total += work.deconv_ops(lat, k, *dec[0])
    total += work.conv_ops(4 * lat, k, *dec[1]) + work.conv_ops(4 * lat, k, *dec[2])
    total += work.deconv_ops(4 * lat, k, *dec[3])
    return total


def kernel_bounds(spec: dict, rows: int) -> dict[str, list[float]]:
    """Bound seconds of each custom-op call of one chunk's forward on the
    ``fused`` route (B1 three times, then B2), at ``rows`` frames."""
    if spec["route"] != "fused":
        return {}
    h, w, cin = spec["image_shape"]
    f, k_out = spec["filters"], spec["out_channels"]
    act = work.DTYPE_BYTES[spec["dtype"]]
    stages = []
    for s, cout in enumerate((f, 2 * f, 4 * f)):
        pool = s < 2
        ops = work.stage_ops(rows, h, w, cin, cout)
        out_px = (h // 2) * (w // 2) if pool else h * w
        moved = (rows * h * w * cin * act + 9 * (cin * cout + 2 * cout * cout) * act
                 + 3 * cout * 4 + rows * out_px * cout * act)
        stages.append(work.bound_s(ops, moved))
        if pool:
            h, w = h // 2, w // 2
        cin = cout
    mid = cin // 2
    pix = rows * h * w
    ops = 2.0 * 9 * pix * (cin * mid + 2 * 4 * mid * mid + 4 * mid * k_out)
    moved = (pix * cin * act + 9 * (cin * mid + 2 * mid * mid + mid * k_out) * act
             + (3 * mid + k_out) * 4 + 16 * pix * k_out * act)
    return {"pose_estimation::fused_encoder_stage": stages,
            "pose_estimation::fused_decoder": [work.bound_s(ops, moved)]}
