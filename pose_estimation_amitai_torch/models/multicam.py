"""Multi-camera CNN fusion models (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/multicam.py``: a shared
per-camera encoder, a fused latent, a shared per-camera decoder on
concat(enc_i, fused) (reference: pytorch/CNNs.py:189-237
``FourCamerasBaseLine``; tensorflow/Network.py:74-125, 245-305, 321-375,
the attention fusion layer at :307-319). ``num_cams`` views of
``C / num_cams`` channels each, view-major on the channel axis.

The torch flavour fuses with a 1x1 ``fusion_conv`` plus the residual; the tf
flavour concatenates, or with ``do_attention`` goes through
``fusion_attn``, flax's ``MultiHeadDotProductAttention`` over the latent
pixels. Its projections keep flax's DenseGeneral layout ((c, heads,
key_dim) in, (heads, key_dim, c) out), so the weight bridge copies them as
they are. JAX runs this attention outside any Pallas kernel; here it is
plain ``torch`` matmuls too.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .cnn import _nchw, _nhwc
from .layers import Conv, DecoderUp, EncoderAtrous


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral``: ``weight`` of shape (*in_dims, *out_dims),
    contracting the input's last ``len(in_dims)`` axes; ``bias`` of the
    output dims. Held in ``dtype``, computed in the input's dtype.
    ``fan_in`` is the product of the contracting dims (train/loop.py's
    lecun-normal init)."""

    def __init__(self, in_dims: tuple[int, ...], out_dims: tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*in_dims, *out_dims, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(*out_dims, dtype=dtype))
        self.n_in = len(in_dims)
        self.fan_in = math.prod(in_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        dims = list(range(x.ndim - self.n_in, x.ndim))
        return torch.tensordot(x, w, dims=(dims, list(range(self.n_in)))) + b


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no mask,
    no dropout): q, k, v projections to (heads, key_dim), the query scaled
    by 1 / sqrt(key_dim), the softmax in the module's dtype, the output
    projection back to ``features``."""

    def __init__(self, features: int, num_heads: int, key_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.key_dim = key_dim
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((features,), (num_heads, key_dim), dtype))
        self.out = DenseGeneral((num_heads, key_dim), (features,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, N, H, D)
        q = q / torch.tensor(self.key_dim ** 0.5, dtype=q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class LatentSelfAttention(nn.Module):
    """Self-attention over the flattened latent pixels with a residual
    (tensorflow/Network.py:307-319): NCHW (B, c, h, w) in and out."""

    def __init__(self, channels: int, num_heads: int = 8, key_dim: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.mha = MultiHeadDotProductAttention(channels, num_heads, key_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        seq = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        attn = self.mha(seq).to(x.dtype)
        return x + attn.reshape(b, h, w, c).permute(0, 3, 1, 2)


class MultiCamNet(nn.Module):
    """Shared per-camera encoder + latent fusion + shared per-camera decoder.

    ``fold_views`` folds the views into the batch for the shared encoder and
    decoder; unfolded, each view takes its own pass. Both apply the same
    modules and agree to float32 rounding. Dropout draws from ``generator``
    in training mode (each unfolded view's pass draws anew, as in JAX).
    """

    def __init__(
        self, in_channels: int, out_channels: int, num_cams: int = 4,
        filters: int = 64, kernel_size: int = 3, dilation: int = 2,
        dropout: float = 0.5, num_blocks: int = 2, flavor: str = "torch",
        do_attention: bool = False, dtype: torch.dtype = torch.bfloat16,
        fold_views: bool = True,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.num_cams = num_cams
        self.flavor = flavor
        self.do_attention = do_attention
        self.dtype = dtype
        self.fold_views = fold_views
        self.shared_encoder = EncoderAtrous(
            in_channels // num_cams, filters, kernel_size, dilation, flavor, dtype,
            dropout, num_blocks)
        ec = self.shared_encoder.out_channels
        merged = num_cams * ec
        if flavor == "torch":
            # fused latent + residual (pytorch/CNNs.py:216-223)
            self.fusion_conv = Conv(merged, merged, 1, dtype=dtype)
        elif do_attention:
            self.fusion_attn = LatentSelfAttention(merged, dtype=dtype)
        self.shared_decoder = DecoderUp(
            ec + merged, out_channels // num_cams, kernel_size, flavor, dtype,
            filters, num_blocks)

    def fuse(self, merged: torch.Tensor) -> torch.Tensor:
        if self.flavor == "torch":
            return self.fusion_conv(merged) + merged
        if self.do_attention:
            return self.fusion_attn(merged)
        return merged

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        b, h, w, c = x.shape
        v = self.num_cams
        cc = c // v
        if not self.fold_views:
            # contiguous NCHW views, as the folded path's: a conv's sums run
            # in another order on another memory format
            encs = [self.shared_encoder(
                _nchw(x[..., i * cc : (i + 1) * cc], self.dtype).contiguous(), generator)
                for i in range(v)]
            fused = self.fuse(torch.cat(encs, dim=1))
            outs = [self.shared_decoder(torch.cat([e, fused], dim=1)) for e in encs]
            return _nhwc(torch.cat(outs, dim=1))
        # views into the batch: (B, H, W, V, cc) -> (B * V, cc, H, W)
        xv = x.to(self.dtype).reshape(b, h, w, v, cc).permute(0, 3, 4, 1, 2)
        enc = self.shared_encoder(xv.reshape(b * v, cc, h, w), generator)
        _, ec, hh, ww = enc.shape
        encs = enc.reshape(b, v, ec, hh, ww)
        fused = self.fuse(encs.reshape(b, v * ec, hh, ww))
        dec_in = torch.cat(
            [encs, fused[:, None].expand(b, v, *fused.shape[1:])], dim=2,
        ).reshape(b * v, ec + fused.shape[1], hh, ww)
        out = self.shared_decoder(dec_in)  # (B * V, K / V, H, W)
        return _nhwc(out.reshape(b, self.out_channels, h, w))
