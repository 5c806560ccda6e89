"""ViT heatmap models: ViT encoder + CNN decoder, and the 4-camera
cross-attention ViT (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/models/vit.py``, class for
class: ``Attention``, ``FeedForward``, ``Transformer`` (the ``torch`` pre-LN
and the ``tf`` post-LN flavours), ``PatchEmbed``, ``CNNDecoderViT``,
``ViTPoseNet``, ``CrossAttentionFuse`` and ``ViT4Cameras`` (views folded
into the batch, or one pass per view). Module and parameter names follow the
flax tree (``patch_embed.proj``, ``transformer.attn{i}.{norm,to_qkv,to_out}``,
``ff{i}.{norm,fc1,fc2}``, ``final_norm``, ``postnorm{i}a/b``,
``decoder.deconv1..4``, ``shared_encoder``, ``fuse{i}``, ``shared_decoder``)
so :func:`..weights.vit_state_dict` maps one onto the other by name.

Numerics as in flax: LayerNorms run in float32 (at least: a float64 module
on float64 parameters stays in float64) with epsilon 1e-6 on float32
parameters and hand float32 on; Linear and conv layers hold and compute in
``dtype`` (their input is cast to it); gelu is the tanh approximation; the
qkv columns are ordered (3, heads, dim_head).

The attention core has three forms, chosen at construction:

* exact (default): logits in ``dtype``, cast to float32 and scaled, float32
  softmax, cast, second product;
* ``fast_softmax``: scale folded onto q, logits in ``dtype`` with heads
  innermost, float32 row sum, divide in float32, cast;
* ``fused_attention``: the exact float32 softmax through the hand-written
  kernel of ``ops/hopper_attention.py`` (its plain version on CPU tensors),
  on strided views of the qkv tensor. It has no JAX counterpart on a serving
  route (the TPU kernel stayed an experiment); excludes ``fast_softmax``.

``fused_serving`` (with ``fast_softmax`` and pre-norm) merges the per-head V
and output projections, as the JAX module does; no serving route engages it.

In training mode (``module.train()``) the attention core is always the exact
one, whatever the serving switches say (flax engages them only when ``not
train``; the attention kernel has no backward), and dropout applies where
flax puts it: on the post-softmax probabilities (the tf flavour's fixed
0.1) and after the GELU and ``fc2``, drawn from the ``torch.Generator``
each forward takes. The layers cast their weights to the activations'
dtype where they apply them, so the train step's float32 parameters run in
a bf16 module.

Frames in and maps out are NHWC, the JAX contract.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hopper_attention import fused_attention
from .layers import Deconv, Dense, at_least_f32, deconv_same_pads, drop, leaky

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, dtype=torch.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default form


TF_ATTENTION_DROPOUT = 0.1  # the tf flavour's fixed rate, vitPose.py:66


class Attention(nn.Module):
    """Multi-head self-attention with fused qkv, pre-LN or raw input
    (reference: pytorch/pytorch_vit_encoder.py:31-78; the tf flavour's keras
    MultiHeadAttention has biased q/k/v, tensorflow/vitPose.py:66-68)."""

    def __init__(
        self, dim: int, heads: int = 8, dim_head: int = 64,
        dtype: torch.dtype = torch.bfloat16, pre_norm: bool = True,
        qkv_bias: bool = False, fast_softmax: bool = False,
        fused_serving: bool = False, fused_attention: bool = False,
        dropout: float = 0.0,
    ):
        super().__init__()
        if fused_attention and fast_softmax:
            raise ValueError(
                "fused_attention computes the exact float32 softmax; it "
                "excludes fast_softmax")
        self.dim, self.heads, self.dim_head = dim, heads, dim_head
        self.dropout = dropout
        self.dtype = dtype
        self.pre_norm = pre_norm
        self.qkv_bias = qkv_bias
        self.fast_softmax = fast_softmax
        self.fused_serving = fused_serving
        self.fused_attention = fused_attention
        inner = heads * dim_head
        if pre_norm:
            self.norm = _layer_norm(dim)
        self.to_qkv = Dense(dim, inner * 3, bias=qkv_bias, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        serving = not self.training
        if serving and self.fused_serving and self.pre_norm and self.fast_softmax:
            return self._fused_forward(x)
        y = self.norm(at_least_f32(x)) if self.pre_norm else at_least_f32(x)
        b, n, _ = y.shape
        h, dh = self.heads, self.dim_head
        qkv = self.to_qkv(y).view(b, n, 3, h, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, D)
        scale = dh ** -0.5
        if serving and self.fused_attention:
            out = torch.empty((b, n, h, dh), dtype=qkv.dtype, device=qkv.device)
            fused_attention(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                            v.permute(0, 2, 1, 3), out=out.permute(0, 2, 1, 3))
        elif serving and self.fast_softmax:
            out = self._fast_core(q * torch.tensor(scale, dtype=q.dtype), k, v)
        else:
            logits = at_least_f32(torch.einsum("bnhd,bmhd->bhnm", q, k)) * scale
            attn = torch.softmax(logits, dim=-1).to(self.dtype)
            attn = drop(attn, self.dropout if self.training else 0.0, generator)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.to_out(out.reshape(b, n, h * dh))

    def _fast_core(self, qs, k, v, pattern: str = "bnmh,bmhd->bnhd"):
        """The bf16 softmax chain: logits in ``dtype`` with heads innermost,
        max-subtracted exp, float32 row sum, divide in float32, cast."""
        logits = torch.einsum("bnhd,bmhd->bnmh", qs, k)
        e = torch.exp(logits - logits.amax(dim=2, keepdim=True))
        s = e.sum(dim=2, keepdim=True, dtype=torch.float32)
        attn = (e.float() / s).to(self.dtype)
        return torch.einsum(pattern, attn, v)

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Merged V/out projection on the same parameters: W_vo[h] = Wv[h] @
        Wo[h], so the (B, N, heads * dim_head) attention output and the
        to_out product never exist. The merged weights are formed in
        float32 from the held parameters at every call."""
        b, n, dim = x.shape
        h, dh = self.heads, self.dim_head
        inner = h * dh
        y = self.norm(x.float())
        wqkv = self.to_qkv.weight.float().t()  # (dim, 3 * inner), flax layout
        wo = self.to_out.weight.float().t()  # (inner, dim)
        scale = dh ** -0.5
        w3 = wqkv.reshape(dim, 3, h, dh)
        wq = w3[:, 0].reshape(dim, inner) * scale  # softmax scale folded
        wk = w3[:, 1].reshape(dim, inner)
        wo_h = wo.reshape(h, dh, self.dim)
        wvo = torch.einsum("dhe,heo->dho", w3[:, 2], wo_h)
        w_all = torch.cat([wq, wk, wvo.reshape(dim, h * self.dim)], dim=1)
        out_const = torch.zeros(self.dim, device=x.device)
        z = y.to(self.dtype) @ w_all.to(self.dtype)
        if self.to_qkv.bias is not None:
            b3 = self.to_qkv.bias.float().reshape(3, h, dh)
            d = torch.cat([b3[0].reshape(inner) * scale, b3[1].reshape(inner),
                           torch.zeros(h * self.dim, device=x.device)])
            # softmax rows sum to 1, so the V bias contracts to a constant
            out_const = torch.einsum("hd,hdo->o", b3[2], wo_h)
            z = z + d.to(self.dtype)
        q = z[..., :inner].reshape(b, n, h, dh)
        k = z[..., inner:2 * inner].reshape(b, n, h, dh)
        vt = z[..., 2 * inner:].reshape(b, n, h, self.dim)
        out = self._fast_core(q, k, vt, "bnmh,bmhe->bne")
        return out + (self.to_out.bias.float() + out_const).to(self.dtype)


class FeedForward(nn.Module):
    """LN -> Linear -> GELU -> Linear (pytorch_vit_encoder.py:12-28); the tf
    flavour takes the raw input and uses relu (vitPose.py:71)."""

    def __init__(
        self, dim: int, hidden_dim: int, dtype: torch.dtype = torch.bfloat16,
        pre_norm: bool = True, activation: str = "gelu", dropout: float = 0.0,
    ):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.pre_norm = pre_norm
        self.activation = activation
        if pre_norm:
            self.norm = _layer_norm(dim)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        y = self.norm(at_least_f32(x)) if self.pre_norm else x
        y = self.fc1(y)
        y = F.relu(y) if self.activation == "relu" else _gelu(y)
        y = self.fc2(drop(y, rate, generator))
        return drop(y, rate, generator)


class Transformer(nn.Module):
    """Transformer stack. ``torch``: pre-LN blocks and a trailing LayerNorm
    (pytorch_vit_encoder.py:81-105). ``tf``: post-LN blocks, raw biased
    attention + skip then LN, relu FFN + skip then LN, no trailing norm
    (tensorflow/vitPose.py:63-79)."""

    def __init__(
        self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
        dtype: torch.dtype = torch.bfloat16, flavor: str = "torch",
        fast_softmax: bool = False, fused_serving: bool = False,
        fused_attention: bool = False, dropout: float = 0.0,
    ):
        super().__init__()
        self.depth = depth
        self.flavor = flavor
        tf = flavor == "tf"
        for i in range(depth):
            self.add_module(f"attn{i}", Attention(
                dim, heads, dim_head, dtype, pre_norm=not tf, qkv_bias=tf,
                fast_softmax=fast_softmax,
                fused_serving=fused_serving and not tf,
                fused_attention=fused_attention,
                dropout=TF_ATTENTION_DROPOUT if tf else dropout))
            self.add_module(f"ff{i}", FeedForward(
                dim, mlp_dim, dtype, pre_norm=not tf,
                activation="relu" if tf else "gelu",
                dropout=0.0 if tf else dropout))
            if tf:
                self.add_module(f"postnorm{i}a", _layer_norm(dim))
                self.add_module(f"postnorm{i}b", _layer_norm(dim))
        if not tf:
            self.final_norm = _layer_norm(dim)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        for i in range(self.depth):
            attn, ff = getattr(self, f"attn{i}"), getattr(self, f"ff{i}")
            if self.flavor == "tf":
                x = getattr(self, f"postnorm{i}a")(at_least_f32(x + attn(x, generator)))
                x = getattr(self, f"postnorm{i}b")(at_least_f32(x + ff(x, generator)))
            else:
                x = attn(x, generator) + x
                x = ff(x, generator) + x
        return x if self.flavor == "tf" else self.final_norm(at_least_f32(x))


class PatchConv(nn.Conv2d):
    """The JAX module's stride-p ``"VALID"`` patch conv (an OIHW kernel),
    applied as unfold + matmul, the same sums: NHWC frames in (cast to
    ``dtype``, as flax's ``nn.Conv(dtype=)`` casts them), (B, N, dim)
    tokens out, row-major over the patch grid. Rows and columns past the
    last whole patch are dropped, as the strided conv drops them."""

    def __init__(self, cin: int, dim: int, patch_size: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, dim, patch_size, stride=patch_size, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        b, h, _, c = x.shape
        p = self.kernel_size[0]
        g = h // p
        # patches in (C, p, p) order against the OIHW kernel flattened
        patches = x[:, : g * p, : g * p].reshape(b, g, p, g, p, c)
        patches = patches.permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, c * p * p)
        return F.linear(patches, self.weight.flatten(1).to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class PatchEmbed(nn.Module):
    """Patch embedding + learned positional embedding
    (pytorch_vit_encoder.py:131-144, tensorflow/vitPose.py:6-60). Takes NHWC
    frames, returns (B, N, dim) tokens in ``dtype``, row-major over the
    patch grid."""

    def __init__(
        self, in_channels: int, n_tokens: int, dim: int, patch_size: int = 16,
        post_norm: bool = True, dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.proj = PatchConv(in_channels, dim, patch_size, dtype)
        if post_norm:
            self.embed_norm = _layer_norm(dim)
        self.post_norm = post_norm
        self.pos_embedding = nn.Parameter(
            torch.empty((1, n_tokens, dim), dtype=torch.float32))
        nn.init.normal_(self.pos_embedding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        # the CNN decoder rebuilds a SQUARE token grid from sqrt(N)
        if h != w:
            raise ValueError(f"ViT path needs square inputs, got {h}x{w}")
        y = self.proj(x.to(self.dtype))
        if self.post_norm:
            y = self.embed_norm(at_least_f32(y))
        return (y + self.pos_embedding.to(y.dtype)).to(self.dtype)


class CNNDecoderViT(nn.Module):
    """Token grid -> heatmaps via 4 stride-2 deconvs, LeakyReLU 0.1 on each.

    ``torch``: constant-width deconvs with the ``ConvTranspose2d(k, s2, p1,
    op1)`` crop, per-sample min-max normalisation in float32 (pytorch/
    VITs.py:13-58) unless ``normalize_output`` is off (peaks-only serving:
    the maps stay in ``dtype``). ``tf``: channel-halving deconvs padded
    "SAME" (one more row and column of low padding than the torch crop, so
    the layer runs unpadded and drops its last row and column), float32
    out, no normalisation (tensorflow/vitPose.py:82-96). ``ref_token_grid``:
    the reference's raw ``reshape(b, d, g, g)`` of the tokens, which
    imported reference checkpoints were trained against."""

    def __init__(
        self, out_channels: int, dim: int, kernel_size: int = 3,
        flavor: str = "torch", dtype: torch.dtype = torch.bfloat16,
        normalize_output: bool = True, ref_token_grid: bool = False,
    ):
        super().__init__()
        self.flavor = flavor
        self.dtype = dtype
        self.normalize_output = normalize_output
        self.ref_token_grid = ref_token_grid
        k = kernel_size
        if flavor == "torch":
            # the reference's ConvTranspose2d(k, s2, p1, op1) crop
            widths, pads = (dim, dim, dim, out_channels), (k - 2, k - 1)
        else:
            widths, pads = (dim // 2, dim // 4, dim // 8, out_channels), deconv_same_pads(k, 2)
        cin = dim
        for i, cout in enumerate(widths):
            self.add_module(f"deconv{i + 1}", Deconv(cin, cout, k, 2, pads, dtype))
            cin = cout

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, n, d = tokens.shape
        g = int(round(n ** 0.5))
        if self.ref_token_grid:
            x = tokens.reshape(b, d, g, g)  # row-major cast, already NCHW
        else:
            x = tokens.reshape(b, g, g, d).permute(0, 3, 1, 2)
        x = x.to(self.dtype)
        for i in range(1, 5):
            x = leaky(getattr(self, f"deconv{i}")(x))
        x = x.permute(0, 2, 3, 1)  # NHWC
        if self.flavor == "torch" and not self.normalize_output:
            return x
        x = at_least_f32(x)
        if self.flavor == "torch":
            lo = x.amin(dim=(1, 2, 3), keepdim=True)
            hi = x.amax(dim=(1, 2, 3), keepdim=True)
            x = (x - lo) / (hi - lo + 1e-12)
        return x


class ViTPoseNet(nn.Module):
    """ViT encoder + CNN decoder heatmap model (pytorch/VITs.py:197-229;
    tensorflow/vitPose.py:100-130). (B, H, W, in_channels) frames ->
    (B, H, W, out_channels) maps."""

    def __init__(
        self, in_channels: int, image_size: int, out_channels: int,
        patch_size: int = 16, dim: int = 256, depth: int = 8, heads: int = 8,
        dim_head: int = 64, mlp_expand: int = 4, kernel_size: int = 3,
        flavor: str = "torch", dtype: torch.dtype = torch.bfloat16,
        normalize_output: bool = True, ref_token_grid: bool = False,
        fast_softmax: bool = False, fused_serving: bool = False,
        fused_attention: bool = False, dropout: float = 0.0,
    ):
        super().__init__()
        self.flavor = flavor
        self.dtype = dtype
        self.normalize_output = normalize_output
        self.fast_softmax = fast_softmax
        self.fused_serving = fused_serving
        self.fused_attention = fused_attention
        self.patch_embed = PatchEmbed(
            in_channels, (image_size // patch_size) ** 2, dim, patch_size,
            post_norm=flavor == "torch", dtype=dtype)
        self.transformer = Transformer(
            dim, depth, heads, dim_head, dim * mlp_expand, dtype, flavor,
            fast_softmax, fused_serving, fused_attention, dropout)
        self.decoder = CNNDecoderViT(
            out_channels, dim, kernel_size, flavor, dtype, normalize_output,
            ref_token_grid)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        return self.decoder(self.transformer(self.patch_embed(x), generator))


class CrossAttentionFuse(nn.Module):
    """One fusion block over concatenated camera tokens (pytorch/
    VITs.py:235-249): a depth-1 Transformer (4 heads of ``output_dim``) on
    the ``input_dim``-wide concat, then LN + Linear back to ``output_dim`` +
    GELU."""

    def __init__(
        self, input_dim: int, output_dim: int,
        dtype: torch.dtype = torch.bfloat16, fast_softmax: bool = False,
        fused_serving: bool = False, fused_attention: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.transformer = Transformer(
            input_dim, 1, 4, output_dim, output_dim, dtype, "torch",
            fast_softmax, fused_serving, fused_attention)
        self.norm = _layer_norm(input_dim)
        self.proj = Dense(input_dim, output_dim, dtype=dtype)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        y = self.norm(at_least_f32(self.transformer(x, generator)))
        return _gelu(self.proj(y))


class ViT4Cameras(nn.Module):
    """Shared ViT encoder per camera + cross-attention fusion + shared
    decoder (pytorch/VITs.py:252-306). Input (B, H, W, 4 * Cc): 4 camera
    views of Cc channels, concatenated on channels; output (B, H, W,
    out_channels), a quarter of the channels per view.

    ``fold_views`` folds the views into the batch for the encoder, fusion
    blocks and decoder (one pass at 4x batch); off, each view takes its own
    pass. Both give the same maps (min-max is per sample and view either
    way)."""

    NUM_CAMS = 4

    def __init__(
        self, in_channels: int, image_size: int, out_channels: int,
        patch_size: int = 16, dim: int = 256, depth: int = 8, heads: int = 8,
        dim_head: int = 64, mlp_expand: int = 4, kernel_size: int = 3,
        num_fuse_layers: int = 4, dtype: torch.dtype = torch.bfloat16,
        normalize_output: bool = True, fast_softmax: bool = False,
        fused_serving: bool = False, fused_attention: bool = False,
        fold_views: bool = True, dropout: float = 0.0,
    ):
        super().__init__()
        v = self.NUM_CAMS
        self.out_channels = out_channels
        self.dtype = dtype
        self.normalize_output = normalize_output
        self.fast_softmax = fast_softmax
        self.fused_serving = fused_serving
        self.fused_attention = fused_attention
        self.fold_views = fold_views
        self.num_fuse_layers = num_fuse_layers
        self.patch_embed = PatchEmbed(
            in_channels // v, (image_size // patch_size) ** 2, dim,
            patch_size, dtype=dtype)
        self.shared_encoder = Transformer(
            dim, depth, heads, dim_head, dim * mlp_expand, dtype, "torch",
            fast_softmax, fused_serving, fused_attention, dropout)
        for i in range(num_fuse_layers):
            self.add_module(f"fuse{i}", CrossAttentionFuse(
                dim * (v + 1), dim, dtype, fast_softmax, fused_serving,
                fused_attention))
        self.shared_decoder = CNNDecoderViT(
            out_channels // v, dim, kernel_size, "torch", dtype,
            normalize_output)

    def _fuses(self) -> list[nn.Module]:
        return [getattr(self, f"fuse{i}") for i in range(self.num_fuse_layers)]

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        v = self.NUM_CAMS
        b, h, w, c = x.shape
        cc = c // v
        if not self.fold_views:
            views = [x[..., i * cc:(i + 1) * cc] for i in range(v)]
            encs = [self.shared_encoder(self.patch_embed(xv), generator) for xv in views]
            skips = list(encs)
            merged = torch.cat(encs, dim=-1)  # (B, N, 4 * dim)
            for fuse in self._fuses():
                encs = [fuse(torch.cat([e, merged], dim=-1), generator) + e
                        for e in encs]
            out = torch.cat(
                [self.shared_decoder(e + s) for e, s in zip(encs, skips)], dim=-1)
            return at_least_f32(out) if self.normalize_output else out
        xv = x.reshape(b, h, w, v, cc).movedim(3, 1).reshape(b * v, h, w, cc)
        tokens = self.shared_encoder(self.patch_embed(xv), generator)  # (B * V, N, D)
        n, d = tokens.shape[1:]
        encs = tokens.reshape(b, v, n, d)
        skips = encs
        merged = encs.movedim(1, 2).reshape(b, n, v * d)
        for fuse in self._fuses():
            fin = torch.cat(
                [encs, merged[:, None].expand(b, v, n, v * d)], dim=-1
            ).reshape(b * v, n, d + v * d)
            encs = fuse(fin, generator).reshape(b, v, n, d) + encs
        out = self.shared_decoder((encs + skips).reshape(b * v, n, d))
        out = out.reshape(b, v, h, w, -1).movedim(1, 3)
        out = out.reshape(b, h, w, self.out_channels)
        return at_least_f32(out) if self.normalize_output else out

