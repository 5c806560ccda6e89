"""The 4-camera disentanglement model, ``FourCamerasDisentanglement``
(reference: pytorch/CNNs.py:240-352, model type
``ALL_CAMS_DISENTANGLED_PER_WING_CNN``), as a plain float32 reference.

Per sample, four views of ``image_shape[2] / 4`` channels side by side:
each view through one shared torch-flavour encoder (the flagship's three
stages of three dilated 3x3 convs, pytorch/CNNs.py:73-88); a 1x1
``rearrange1`` to ``latent_3d_channels`` (3G); the inverse FTL, each pixel's
G groups of 3 channels through the view's (4, 3) pseudo-inverse camera
``P_inv``, to 4G canonical channels; the four views' canonical channels
side by side through the 1x1 ``fusion1`` (16G -> 4G) and ``fusion2`` (4G ->
4G), each followed by BatchNorm on its running averages and ReLU; the FTL
back through each view's (3, 4) camera ``P`` to 3G channels; the shared
BatchNorm ``bn3`` and ReLU; the 1x1 ``rearrange2`` back to the encoder's
width, the encoder's output added; the shared transposed-conv decoder (the
flagship's, pytorch/CNNs.py:151-157). The views' maps side by side, NHWC.

One departure from the source, as the port's registry has it: the FTL
groups the channels of each pixel (channel 3g + j of the NCHW latent is
entry j of group g), where pytorch/CNNs.py:335 and :348 reinterpret the
NCHW latent's memory as (h, w, G, 3), which mixes channels and positions.

Leaves carry flax's names; the BatchNorms' running averages are under
``batch_stats/`` (the flax collection of that name, the port's
``Predictor(batch_stats=...)``). ``VAL_MODE``: the served val is the map's
value at the peak.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from .. import work
from . import basicnet, conv_same, conv_transpose, leaky

VAL_MODE = "raw"
VIEWS = 4
EPSILON = 1e-5  # flax nn.BatchNorm's
STATS = "batch_stats"


def view_spec(spec: dict) -> dict:
    """One view's encoder and decoder as the flagship ``BasicNet`` of the
    ``basicnet`` family: a view's channels in, a view's maps out."""
    v = copy.deepcopy(spec)
    h, w, c = spec["image_shape"]
    v["image_shape"] = [h, w, c // VIEWS]
    v["out_channels"] = spec["out_channels"] // VIEWS
    return v


def _widths(spec: dict) -> tuple[int, int, int]:
    """(encoder width, latent 3G, canonical 4G)."""
    lat = spec["latent_3d_channels"]
    return 4 * spec["filters"], lat, lat // 3 * 4


def _one_by_one(spec: dict) -> list[tuple[str, int, int]]:
    enc, lat, canon = _widths(spec)
    return [("rearrange1", enc, lat), ("fusion1", VIEWS * canon, canon),
            ("fusion2", canon, canon), ("rearrange2", lat, enc)]


def leaves(spec: dict) -> list[tuple[str, tuple, str, int]]:
    """The view's encoder and decoder leaves under ``shared_encoder/`` and
    ``shared_decoder/``, the 1x1s, and each BatchNorm's scale (around 1),
    bias and running averages: means of std 1, variances around 1 (std
    0.1, so kept away from 0)."""
    out = []
    for path, shape, kind, fan in basicnet.leaves(view_spec(spec)):
        scope = "shared_encoder" if path.startswith("encoder/") else "shared_decoder"
        out.append((f"{scope}/{path.split('/', 1)[1]}", shape, kind, fan))
    for name, cin, cout in _one_by_one(spec):
        out += [(f"{name}/kernel", (1, 1, cin, cout), "kernel", cin),
                (f"{name}/bias", (cout,), "bias", 0)]
    _, lat, canon = _widths(spec)
    for name, c in (("bn1", canon), ("bn2", canon), ("bn3", lat)):
        out += [(f"{name}/scale", (c,), "scale", 0), (f"{name}/bias", (c,), "shift", 0),
                (f"{STATS}/{name}/mean", (c,), "embed", 0),
                (f"{STATS}/{name}/var", (c,), "scale", 0)]
    return out


def split_tree(tree: dict) -> tuple[dict, dict]:
    """A drawn tree -> (flax ``params``, flax ``batch_stats``)."""
    params = {k: v for k, v in tree.items() if k != STATS}
    return params, tree[STATS]


def _view_params(p: dict) -> dict:
    """The shared encoder's and decoder's leaves under the ``basicnet``
    family's names."""
    out = {}
    for path, t in p.items():
        for scope, name in (("shared_encoder/", "encoder/"), ("shared_decoder/", "decoder/")):
            if path.startswith(scope):
                out[name + path[len(scope):]] = t
    return out


def _encode(p: dict, x: torch.Tensor, dil: int, quant) -> torch.Tensor:
    for stage in range(3):
        c = [(p[f"encoder/conv{3 * stage + i}/kernel"], p[f"encoder/conv{3 * stage + i}/bias"])
             for i in (1, 2, 3)]
        x1 = leaky(conv_same(x, *c[0], dil, quant))
        x2 = leaky(conv_same(x1, *c[1], dil, quant)) + x1
        x = leaky(conv_same(x2, *c[2], dil, quant)) + x2
        if stage < 2:
            x = leaky(F.max_pool2d(x, 2, 2))
    return x


def _decode(p: dict, x: torch.Tensor, k: int, quant) -> torch.Tensor:
    d = [(p[f"decoder/deconv{i}/kernel"], p[f"decoder/deconv{i}/bias"]) for i in (1, 2, 3, 4)]
    up, same = (k - 2, k - 1), (k // 2, (k - 1) - k // 2)
    y1 = leaky(conv_transpose(x, *d[0], 2, up, quant))
    y2 = leaky(conv_transpose(y1, *d[1], 1, same, quant)) + y1
    y3 = leaky(conv_transpose(y2, *d[2], 1, same, quant)) + y2
    return leaky(conv_transpose(y3, *d[3], 2, up, quant))


def _ftl(t: torch.Tensor, cam: torch.Tensor, quant) -> torch.Tensor:
    """Each pixel's groups of ``cam``'s columns through each sample's
    ``cam``: NCHW (B, G j, h, w) -> (B, G i, h, w)."""
    b, c, h, w = t.shape
    i, j = cam.shape[-2:]
    out = torch.einsum("bgjhw,bij->bgihw", quant(t.reshape(b, c // j, j, h, w)), quant(cam))
    return out.reshape(b, c // j * i, h, w)


def forward(p: dict, frames: torch.Tensor, spec: dict, quant=lambda t: t,
            P: torch.Tensor | None = None, P_inv: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W, 4 Cc) float32 frames and the samples' cameras, P (B, 4, 3,
    4) and P_inv (B, 4, 4, 3) -> (B, H, W, K) float32 maps, view v's in
    channels v K/4 .. (v + 1) K/4."""
    dil, k = spec["dilation"], spec["kernel_size"]
    vp = _view_params(p)

    def one_by_one(x: torch.Tensor, name: str) -> torch.Tensor:
        return conv_same(x, p[f"{name}/kernel"], p[f"{name}/bias"], 1, quant)

    def bn(x: torch.Tensor, name: str) -> torch.Tensor:
        mean, var = p[f"{STATS}/{name}/mean"], p[f"{STATS}/{name}/var"]
        scale, bias = p[f"{name}/scale"], p[f"{name}/bias"]
        y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + EPSILON)
        return y * scale[:, None, None] + bias[:, None, None]

    cc = frames.shape[-1] // VIEWS
    x = frames.permute(0, 3, 1, 2)
    encs = [_encode(vp, x[:, v * cc : (v + 1) * cc], dil, quant) for v in range(VIEWS)]
    canon = [_ftl(one_by_one(e, "rearrange1"), P_inv[:, v], quant) for v, e in enumerate(encs)]
    f = F.relu(bn(one_by_one(torch.cat(canon, dim=1), "fusion1"), "bn1"))
    f = F.relu(bn(one_by_one(f, "fusion2"), "bn2"))
    maps = []
    for v, e in enumerate(encs):
        t = F.relu(bn(_ftl(f, P[:, v], quant), "bn3"))
        maps.append(_decode(vp, one_by_one(t, "rearrange2") + e, k, quant))
    return torch.cat(maps, dim=1).permute(0, 2, 3, 1)


def middle_ops(spec: dict) -> float:
    """2 x multiply-adds of one sample's middle: the four 1x1s and the two
    FTLs (each pixel's G groups, 3 x 4 products a group and view)."""
    h, w = spec["image_shape"][:2]
    pix = (h // 4) * (w // 4)
    _, lat, _ = _widths(spec)
    total = 0.0
    for name, cin, cout in _one_by_one(spec):
        views = VIEWS if name.startswith("rearrange") else 1
        total += views * work.matmul_ops(pix, cin, cout)
    return total + 2 * VIEWS * work.matmul_ops(pix * (lat // 3), 3, 4)


def flops_per_frame(spec: dict) -> float:
    """2 x multiply-adds of one sample's forward: four views' encoder and
    decoder, and the middle."""
    return VIEWS * basicnet.flops_per_frame(view_spec(spec)) + middle_ops(spec)


def kernel_bounds(spec: dict, rows: int) -> dict[str, list[float]]:
    """Bound seconds of each custom-op call of one chunk's forward on the
    ``fused`` route, at ``rows`` samples: B1 three times and B2 once on the
    4 x ``rows`` view-rows, and ``ftl_fusion`` once: its operations at the
    bf16 peak, or its least bytes (each view-row's latent and skip read,
    its output written, in the compute dtype; the weights; the cameras) at
    the memory peak, the larger."""
    if spec["route"] != "fused":
        return {}
    out = basicnet.kernel_bounds(view_spec(spec), VIEWS * rows)
    h, w = spec["image_shape"][:2]
    enc, lat, canon = _widths(spec)
    act = work.DTYPE_BYTES[spec["dtype"]]
    weights = sum((cin + 1) * cout * act for _, cin, cout in _one_by_one(spec))
    weights += 4 * 4 * (2 * canon + lat)
    moved = (3 * VIEWS * rows * (h // 4) * (w // 4) * enc * act + weights
             + rows * VIEWS * 2 * 12 * 4)
    out["pose_estimation::ftl_fusion"] = [work.bound_s(rows * middle_ops(spec), moved)]
    return out
