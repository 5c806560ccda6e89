"""The serving kernels, and the disentanglement model's middle, as
``torch.library`` custom operators.

``torch.export`` traces a program on fake tensors, which have no
``data_ptr``, so it cannot trace a ctypes launch; and a wrapper called on a
CPU fake tensor would be traced into its plain decomposition. Registered as
custom ops, with a fake implementation that gives the exact output shape,
dtype and layout, the kernels stay one node each in an exported graph
(deploy.py), and a loaded program launches the same hand-written kernels:

* ``pose_estimation::fused_encoder_stage`` -- ops/hopper_conv.py
  ``fused_encoder_stage`` (B1);
* ``pose_estimation::fused_decoder`` -- ops/hopper_deconv.py
  ``fused_decoder`` (B2);
* ``pose_estimation::fused_quantized_stage`` -- ops/hopper_qconv.py
  ``fused_quantized_stage`` (B3);
* ``pose_estimation::fused_attention`` -- ops/hopper_attention.py
  ``fused_attention`` (S1), in a functional form: the packed (B, N, 3, H, D)
  qkv tensor in, a fresh (B, N, H, D) output back, so no mutating op
  reaches an exported graph;
* ``pose_estimation::ftl_fusion`` -- ops/ftl_fusion.py ``ftl_fusion``, the
  middle of the 4-camera disentanglement model (rearrange1, the inverse
  FTL, the fusion with its BatchNorms, the FTL, bn3, rearrange2 and the
  skip) on view-rows, with each sample's cameras.

The real implementation of each op calls the wrapper: the CUDA kernel for
CUDA tensors, the plain version for CPU tensors, by device as the wrapper
decides it, and the wrapper's launch counters count as they do for a direct
call. The model code of the fused routes (models/fast_infer.py,
models/quantized.py ``make_quantized_fused_forward``, models/vit.py
``Attention``) calls these ops, so an eager call and an exported program run
the same launches. Importing this module registers the ops.
"""

from __future__ import annotations

import torch

from .ftl_fusion import ftl_fusion as _ftl_fusion
from .hopper_attention import fused_attention as _attention
from .hopper_conv import fused_encoder_stage as _encoder_stage
from .hopper_deconv import fused_decoder as _decoder
from .hopper_qconv import fused_quantized_stage as _quantized_stage

NAMESPACE = "pose_estimation"


@torch.library.custom_op(f"{NAMESPACE}::fused_encoder_stage", mutates_args=())
def fused_encoder_stage(
    x: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    dilation: int, alpha: float, pool: bool,
) -> torch.Tensor:
    """One fused encoder stage: (B, H, W, Cin) -> (B, H/2, W/2, Cout) if
    ``pool`` else (B, H, W, Cout), in x's dtype."""
    return _encoder_stage(x, w1, b1, w2, b2, w3, b3, dilation=dilation,
                          alpha=alpha, pool=pool)


@fused_encoder_stage.register_fake
def _(x, w1, b1, w2, b2, w3, b3, dilation, alpha, pool):
    b, h, w, _ = x.shape
    if pool:  # the plain version pools with ceil_mode; the kernel takes even sizes
        h, w = (h + 1) // 2, (w + 1) // 2
    return x.new_empty((b, h, w, w1.shape[-1]))


@torch.library.custom_op(f"{NAMESPACE}::fused_decoder", mutates_args=())
def fused_decoder(
    latent: torch.Tensor,
    w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
    w4: torch.Tensor, b4: torch.Tensor,
    alpha: float,
) -> torch.Tensor:
    """The fused four-layer decoder: (B, R, W, cin) -> (B, 4R, 4W, K) in
    the latent's dtype."""
    return _decoder(latent, w1, b1, w2, b2, w3, b3, w4, b4, alpha=alpha)


@fused_decoder.register_fake
def _(latent, w1, b1, w2, b2, w3, b3, w4, b4, alpha):
    b, r, w, _ = latent.shape
    return latent.new_empty((b, 4 * r, 4 * w, w4.shape[-1]))


@torch.library.custom_op(f"{NAMESPACE}::fused_quantized_stage", mutates_args=())
def fused_quantized_stage(
    x: torch.Tensor,
    w1: torch.Tensor, m1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, m2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, m3: torch.Tensor, b3: torch.Tensor,
    inv_s2: float, inv_s3: float, inv_out: float,
    dilation: int, alpha: float, pool: bool,
) -> torch.Tensor:
    """One fused int8 encoder stage: (B, H, W, Cin) int8 -> (B, H, W, Cout)
    int8, unpooled (the caller max-pools)."""
    return _quantized_stage(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, inv_s2,
                            inv_s3, inv_out, dilation=dilation, alpha=alpha,
                            pool=pool)


@fused_quantized_stage.register_fake
def _(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, inv_s2, inv_s3, inv_out,
      dilation, alpha, pool):
    b, h, w, _ = x.shape
    return x.new_empty((b, h, w, m1.shape[0]), dtype=torch.int8)


@torch.library.custom_op(f"{NAMESPACE}::fused_attention", mutates_args=())
def fused_attention(qkv: torch.Tensor) -> torch.Tensor:
    """Softmax attention of a packed (B, N, 3, H, D) qkv tensor -> (B, N, H,
    D) in its dtype. The kernel reads q, k and v as strided views of it and
    writes a view of the result: no transposing copy is made."""
    b, n, _, h, d = qkv.shape
    out = qkv.new_empty((b, n, h, d))
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    _attention(q, k, v, out=out.permute(0, 2, 1, 3))
    return out


@fused_attention.register_fake
def _(qkv):
    b, n, _, h, d = qkv.shape
    return qkv.new_empty((b, n, h, d))


@torch.library.custom_op(f"{NAMESPACE}::ftl_fusion", mutates_args=())
def ftl_fusion(
    latent: torch.Tensor, P: torch.Tensor, P_inv: torch.Tensor,
    w_r1: torch.Tensor, b_r1: torch.Tensor, w_f1: torch.Tensor, b_f1: torch.Tensor,
    w_f2: torch.Tensor, b_f2: torch.Tensor, w_r2: torch.Tensor, b_r2: torch.Tensor,
    bn1: torch.Tensor, bn2: torch.Tensor, bn3: torch.Tensor, eps: float,
) -> torch.Tensor:
    """The disentanglement model's middle: (4B, h, w, C) view-rows of the
    encoder's output -> the decoder's (4B, h, w, C) input, in its dtype."""
    return _ftl_fusion(latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2,
                       bn1, bn2, bn3, eps)


@ftl_fusion.register_fake
def _(latent, P, P_inv, w_r1, b_r1, w_f1, b_f1, w_f2, b_f2, w_r2, b_r2, bn1, bn2, bn3, eps):
    return latent.new_empty(latent.shape)
