"""Fused int8 encoder stage and the single int8 conv: Hopper kernels and
plain versions.

Counterpart of ``pose_estimation_amitai_tpu/ops/pallas_qconv.py``
(:func:`fused_quantized_stage`) and of the im2col int8 conv of
``scripts/exp_im2col_pallas.py`` (:func:`quantized_conv3x3`). One int8 stage
of the flagship encoder, on int8 activations and weights with per-channel
dequant multipliers ``m`` (s_x * s_w) and float32 biases:

    y1 = bf16(LReLU(f32(conv(x))  * m1 + b1))          q1 = quant(y1, inv_s2)
    y2 = bf16(LReLU(f32(conv(q1)) * m2 + b2)) + y1     q2 = quant(y2, inv_s3)
    y3 = bf16(LReLU(f32(conv(q2)) * m3 + b3)) + y2     [pool: LReLU in f32]
    out = quant(y3, inv_out)

    quant(v, inv) = int8(clip(rint(f32(bf16(v) * bf16(inv))), -127, 127))

with 3x3 dilated SAME convs accumulated in int32 (exact), bf16 skip adds and
round-half-to-even. The output is (B, H, W, Cout) int8 and unpooled: with
``pool`` the stage applies the post-pool LeakyReLU before the quant and the
caller max-pools the int8 values, which gives the same result because
``quant(LReLU(.))`` is monotone.

The single conv is ``int8(clip(rint(LReLU(f32(conv(x)) * mult + bias) *
inv_out), -127, 127))`` with a float32 requant.

On a CUDA tensor each wrapper launches ``csrc/qconv_stage.cu``; on a CPU
tensor it runs its plain version. Nothing falls back from one to the other.
The kernels multiply and add with separate roundings (no FMA contraction), so
they equal their plain versions bit for bit.

Each conv runs one of three kernels, and :func:`qconv_kernel_for` chooses
from the shape alone: ``"mma_s8"``, an implicit GEMM on the int8 tensor cores
(input channels a multiple of 32, output channels of 8); ``"mma_s8_c4"``, its
form for 4 input channels, the nine taps of a pixel as the contraction (the
encoder's first conv; output channels a multiple of 8); or ``"dp4a"``, the
direct convolution on the CUDA cores (every other shape). All read the
weights packed four input channels to a
32-bit word, (9, ceil(Cin / 4), Cout) int32: :func:`pack_qconv_weights` makes
that layout once for a model's layers, and every wrapper here takes a weight
either packed or as HWIO int8, which it packs itself.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .hopper_conv import MAX_DILATION, SMEM_MAX, check_operand, lrelu
from .int8_conv import conv_s32

QCONV_KERNEL_CODES = {"dp4a": 0, "mma_s8": 1, "mma_s8_c4": 2}
# the tensor-core kernel's tiling (csrc/qconv_stage.cu)
QMMA_TILE = 16  # output rows and columns of a block
QMMA_COUT = 64  # output channels of a block
QMMA_CIN = 32  # int8 input channels of a staged chunk
QMMA_STAGES = 3  # ring depth


def qconv_mma_smem_bytes(dilation: int) -> int:
    """Shared memory a block of the ``"mma_s8"`` kernel asks for: its ring
    (three stages of the halo'd patch at 32 bytes a pixel and the chunk's
    9 x 8 weight rows of 64 words padded to 72) and a 4-byte table entry a
    patch pixel. The kernel's own figure is
    :func:`qconv_mma_smem_bytes_built`; the card's tests hold the two equal."""
    side = QMMA_TILE + 2 * dilation
    return (QMMA_STAGES * (32 * side * side + 4 * 9 * (QMMA_CIN // 4) * (QMMA_COUT + 8))
            + 4 * side * side)


def qconv_kernel_for(cin: int, cout: int, dilation: int) -> str:
    """Which kernel a CUDA int8 3x3 conv of this shape launches:
    ``"mma_s8"``, ``"mma_s8_c4"`` or ``"dp4a"``. A rule on the shape only.
    (In a stage only the first conv can have 4 input channels beside 8 or
    more output channels, and it has no skip: the 4-channel kernel takes
    none.)"""
    if cout >= 8 and cout % 8 == 0 and 1 <= dilation <= MAX_DILATION:
        if cin == 4:
            return "mma_s8_c4"
        if (cin >= QMMA_CIN and cin % QMMA_CIN == 0
                and qconv_mma_smem_bytes(dilation) <= SMEM_MAX):
            return "mma_s8"
    return "dp4a"


def packed_shape(cin: int, cout: int) -> tuple[int, int, int]:
    """Shape of one layer's packed weights: 9 taps x ceil(cin / 4)
    four-channel words x cout."""
    return (9, -(-cin // 4), cout)


def pack_qconv_weights_plain(w_int8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_qconv_weights`, any device: HWIO
    int8 (3, 3, Cin, Cout) -> (9, ceil(Cin / 4), Cout) int32 with byte k of a
    word = ``w[tap][4 * word + k][cout]``, zero beyond Cin."""
    _, _, cin, cout = w_int8.shape
    words = -(-cin // 4)
    w = torch.nn.functional.pad(w_int8.reshape(9, cin, cout), (0, 0, 0, 4 * words - cin))
    by_word = w.reshape(9, words, 4, cout).permute(0, 1, 3, 2).contiguous()
    return by_word.view(torch.int32).squeeze(-1)  # little endian: byte k at bits 8k


def unpack_qconv_weights_plain(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """The HWIO int8 (3, 3, cin, Cout) weights a packed tensor holds."""
    _, words, cout = packed.shape
    by_word = packed.contiguous().unsqueeze(-1).view(torch.int8)  # (9, words, cout, 4)
    w = by_word.permute(0, 1, 3, 2).reshape(9, 4 * words, cout)[:, :cin]
    return w.reshape(3, 3, cin, cout).contiguous()


def _hwio(w: torch.Tensor, cin: int) -> torch.Tensor:
    """``w`` as HWIO int8, whether it came packed or not."""
    return unpack_qconv_weights_plain(w, cin) if w.dtype == torch.int32 else w


def bf16_round(v: float) -> float:
    """``v`` rounded to the nearest bfloat16, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16))


def quant_bf16(v: torch.Tensor, inv: float) -> torch.Tensor:
    """``int8(clip(rint(bf16(v) * bf16(inv)), -127, 127))``: the requant of
    the int8 serving path, product rounded to bf16, ties to even."""
    scale = torch.tensor(inv, dtype=torch.float32, device=v.device).to(torch.bfloat16)
    p = v.to(torch.bfloat16) * scale
    return p.float().round().clamp(-127, 127).to(torch.int8)


def dequant(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``f32(acc) * mult + bias`` per output channel (NHWC), two roundings."""
    return acc.float() * mult + bias


def fused_quantized_stage_plain(
    x_int8: torch.Tensor,
    w1, m1, b1, w2, m2, b2, w3, m3, b3,
    inv_s2: float, inv_s3: float, inv_out: float,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_quantized_stage`: the same
    arithmetic through the exact library conv, any device."""
    bf = torch.bfloat16
    cout = m1.shape[0]
    w1, w2, w3 = _hwio(w1, x_int8.shape[-1]), _hwio(w2, cout), _hwio(w3, cout)
    y1 = lrelu(dequant(conv_s32(x_int8, w1, dilation), m1, b1), alpha).to(bf)
    q1 = quant_bf16(y1, inv_s2)
    y2 = lrelu(dequant(conv_s32(q1, w2, dilation), m2, b2), alpha).to(bf) + y1
    q2 = quant_bf16(y2, inv_s3)
    y3 = lrelu(dequant(conv_s32(q2, w3, dilation), m3, b3), alpha).to(bf) + y2
    if pool:
        y3 = lrelu(y3.float(), alpha)
    return quant_bf16(y3, inv_out).contiguous()


def quantized_conv3x3_plain(
    x_int8: torch.Tensor, w_int8: torch.Tensor, mult: torch.Tensor,
    bias: torch.Tensor, *, dilation: int = 2, alpha: float = 0.1,
    inv_out: float = 64.0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_conv3x3`, any device."""
    w_int8 = _hwio(w_int8, x_int8.shape[-1])
    y = lrelu(dequant(conv_s32(x_int8, w_int8, dilation), mult, bias), alpha)
    return (y * inv_out).round().clamp(-127, 127).to(torch.int8).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("qconv_stage")
    if lib.pe_fused_quantized_stage.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.pe_fused_quantized_stage
        fn.argtypes = [p] * 15 + [i] * 6 + [f] * 4 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        fn = lib.pe_quantized_conv3x3
        fn.argtypes = [p] * 5 + [i] * 6 + [f, f, i, p]
        fn.restype = ctypes.c_int
        fn = lib.pe_pack_qconv_weights
        fn.argtypes = [p, p, i, i, p]
        fn.restype = ctypes.c_int
        lib.pe_qconv_mma_smem_bytes.argtypes = [i]
        lib.pe_qconv_mma_smem_bytes.restype = ctypes.c_longlong
    return lib


def qconv_mma_smem_bytes_built(dilation: int) -> int:
    """The same figure from the built library: what the launch asks for."""
    return _lib().pe_qconv_mma_smem_bytes(dilation)


def _check_input(x: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous (B, H, W, C) int8 CUDA tensor whose
    batch fits the kernels' grid (<= 65535)."""
    if not x.is_cuda:
        raise ValueError(f"kernel input on {x.device}, expected a CUDA tensor")
    if x.dtype != torch.int8:
        raise TypeError(f"kernel takes int8 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("kernel input must be a contiguous (B, H, W, C)")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch {x.shape[0]} outside 1..65535")
    if x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError("the kernels index a frame's pixels in 32 bits")


def pack_qconv_weights(w_int8: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weights (3, 3, Cin, Cout) in the layout the int8 conv
    kernels read: (9, ceil(Cin / 4), Cout) int32, four input channels a word.
    A CUDA tensor is packed by the library's kernel (one launch, counted in
    ``pack_qconv_weights.launches``), a CPU tensor by the plain version."""
    if w_int8.device.type == "cpu":
        return pack_qconv_weights_plain(w_int8)
    if not w_int8.is_cuda:
        raise ValueError(f"weights on {w_int8.device}, expected a CUDA tensor")
    if w_int8.dim() != 4 or tuple(w_int8.shape[:2]) != (3, 3):
        raise ValueError(f"weights of shape {tuple(w_int8.shape)}, expected (3, 3, Cin, Cout)")
    check_operand("w", w_int8, tuple(w_int8.shape), torch.int8, w_int8.device)
    cin, cout = w_int8.shape[2:]
    packed = torch.empty(packed_shape(cin, cout), dtype=torch.int32, device=w_int8.device)
    with torch.cuda.device(w_int8.device):
        stream = torch.cuda.current_stream(w_int8.device).cuda_stream
        rc = _lib().pe_pack_qconv_weights(
            w_int8.data_ptr(), packed.data_ptr(), cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"pack_qconv_weights kernel: CUDA error {rc}")
    pack_qconv_weights.launches += 1
    return packed


pack_qconv_weights.launches = 0


def _packed_layer(k: str, w, m, b, cin: int, cout: int, dev) -> torch.Tensor:
    """Check one layer's operands; return its weights packed (packing HWIO
    int8 weights here)."""
    check_operand(f"m{k}", m, (cout,), torch.float32, dev)
    check_operand(f"b{k}", b, (cout,), torch.float32, dev)
    if w.dtype == torch.int32:
        check_operand(f"w{k}", w, packed_shape(cin, cout), torch.int32, dev)
        return w
    check_operand(f"w{k}", w, (3, 3, cin, cout), torch.int8, dev)
    return pack_qconv_weights(w)


def _check_kernel(kernel: str, cin: int, cout: int, dilation: int) -> None:
    if kernel not in ("dp4a", qconv_kernel_for(cin, cout, dilation)):
        raise ValueError(
            f"kernel {kernel!r} does not take {cin} -> {cout} channels at "
            f"dilation {dilation}")


def fused_quantized_stage(
    x_int8: torch.Tensor,
    w1, m1, b1, w2, m2, b2, w3, m3, b3,
    inv_s2: float, inv_s3: float, inv_out: float,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """Fused int8 encoder stage.

    Args:
      x_int8: (B, H, W, Cin) int8, quantized at conv1's input scale;
      wK: (3, 3, Cin/Cout, Cout) int8, or packed by
      :func:`pack_qconv_weights`; mK: (Cout,) float32 dequant multipliers
      (s_x * s_w per channel); bK: (Cout,) float32 biases; inv_s2/inv_s3:
      1/s_x of conv2/conv3; inv_out: 1/s_x of the next layer (the stage
      output is int8 at that scale).

    Returns (B, H, W, Cout) int8. With ``pool`` the extra LeakyReLU runs
    before the quant and the caller 2x2 max-pools the int8 output. CUDA
    tensors run ``csrc/qconv_stage.cu`` (three conv launches, q1/y1/q2/y2 in
    a workspace allocated here), each conv on the kernel
    :func:`qconv_kernel_for` names; CPU tensors run the plain version. Each
    kernel run adds one to ``fused_quantized_stage.launches`` and its three
    convs to ``fused_quantized_stage.convs_by_kernel``.
    """
    if x_int8.device.type == "cpu":
        return fused_quantized_stage_plain(
            x_int8, w1, m1, b1, w2, m2, b2, w3, m3, b3, inv_s2, inv_s3,
            inv_out, dilation=dilation, alpha=alpha, pool=pool,
        )
    cin, cout = x_int8.shape[-1], m1.shape[0]
    kernels = tuple(qconv_kernel_for(c, cout, dilation) for c in (cin, cout, cout))
    return fused_quantized_stage_on(
        kernels, x_int8, w1, m1, b1, w2, m2, b2, w3, m3, b3, inv_s2, inv_s3,
        inv_out, dilation=dilation, alpha=alpha, pool=pool)


def fused_quantized_stage_on(
    kernels: tuple[str, str, str],
    x_int8: torch.Tensor,
    w1, m1, b1, w2, m2, b2, w3, m3, b3,
    inv_s2: float, inv_s3: float, inv_out: float,
    *,
    dilation: int = 2,
    alpha: float = 0.1,
    pool: bool = True,
) -> torch.Tensor:
    """:func:`fused_quantized_stage` on CUDA tensors with the kernel of each
    conv named by the caller: the one :func:`qconv_kernel_for` names, or
    ``"dp4a"``, which takes every shape (to time one kernel against the
    other on the same tensors). Raises for any other choice."""
    cin, cout = x_int8.shape[-1], m1.shape[0]
    for k, c in zip(kernels, (cin, cout, cout), strict=True):
        _check_kernel(k, c, cout, dilation)
    _check_input(x_int8)
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation {dilation} outside 1..{MAX_DILATION}")
    b, h, w, _ = x_int8.shape
    dev = x_int8.device
    p1 = _packed_layer("1", w1, m1, b1, cin, cout, dev)
    p2 = _packed_layer("2", w2, m2, b2, cout, cout, dev)
    p3 = _packed_layer("3", w3, m3, b3, cout, cout, dev)
    shape = (b, h, w, cout)
    q1, q2, out = (torch.empty(shape, dtype=torch.int8, device=dev) for _ in range(3))
    y1, y2 = (torch.empty(shape, dtype=torch.bfloat16, device=dev) for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_fused_quantized_stage(
            x_int8.data_ptr(), p1.data_ptr(), m1.data_ptr(), b1.data_ptr(),
            p2.data_ptr(), m2.data_ptr(), b2.data_ptr(),
            p3.data_ptr(), m3.data_ptr(), b3.data_ptr(),
            q1.data_ptr(), y1.data_ptr(), q2.data_ptr(), y2.data_ptr(),
            out.data_ptr(),
            b, h, w, cin, cout, dilation,
            alpha, bf16_round(inv_s2), bf16_round(inv_s3), bf16_round(inv_out),
            int(pool), *(QCONV_KERNEL_CODES[k] for k in kernels), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"fused_quantized_stage kernels {kernels}: CUDA error {rc}")
    fused_quantized_stage.launches += 1
    for k in kernels:
        fused_quantized_stage.convs_by_kernel[k] += 1
    return out


fused_quantized_stage.launches = 0
fused_quantized_stage.convs_by_kernel = dict.fromkeys(QCONV_KERNEL_CODES, 0)


def quantized_conv3x3(
    x_int8: torch.Tensor, w_int8: torch.Tensor, mult: torch.Tensor,
    bias: torch.Tensor, *, dilation: int = 2, alpha: float = 0.1,
    inv_out: float = 64.0,
) -> torch.Tensor:
    """One int8 3x3 dilated SAME conv with its dequant, LeakyReLU and
    float32 requant: (B, H, W, Cin) int8 -> (B, H, W, Cout) int8.

    ``w_int8`` (3, 3, Cin, Cout) int8, or packed by
    :func:`pack_qconv_weights`; ``mult``, ``bias`` (Cout,) float32. CUDA
    tensors run ``csrc/qconv_stage.cu`` (one conv launch, the 9 taps folded
    into the contraction loop) on the kernel :func:`qconv_kernel_for` names;
    CPU tensors run the plain version. Each kernel run adds one to
    ``quantized_conv3x3.launches`` and to
    ``quantized_conv3x3.launches_by_kernel``.
    """
    if x_int8.device.type == "cpu":
        return quantized_conv3x3_plain(
            x_int8, w_int8, mult, bias, dilation=dilation, alpha=alpha,
            inv_out=inv_out,
        )
    kernel = qconv_kernel_for(x_int8.shape[-1], mult.shape[0], dilation)
    return quantized_conv3x3_on(kernel, x_int8, w_int8, mult, bias,
                                dilation=dilation, alpha=alpha, inv_out=inv_out)


def quantized_conv3x3_on(
    kernel: str,
    x_int8: torch.Tensor, w_int8: torch.Tensor, mult: torch.Tensor,
    bias: torch.Tensor, *, dilation: int = 2, alpha: float = 0.1,
    inv_out: float = 64.0,
) -> torch.Tensor:
    """:func:`quantized_conv3x3` on CUDA tensors with the kernel named by the
    caller: the one :func:`qconv_kernel_for` names, or ``"dp4a"``, which
    takes every shape. Raises for any other choice."""
    cin, cout = x_int8.shape[-1], mult.shape[0]
    _check_kernel(kernel, cin, cout, dilation)
    _check_input(x_int8)
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation {dilation} outside 1..{MAX_DILATION}")
    b, h, w, _ = x_int8.shape
    dev = x_int8.device
    packed = _packed_layer("", w_int8, mult, bias, cin, cout, dev)
    out = torch.empty((b, h, w, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_quantized_conv3x3(
            x_int8.data_ptr(), packed.data_ptr(), mult.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, dilation, alpha, inv_out,
            QCONV_KERNEL_CODES[kernel], stream,
        )
    if rc != 0:
        raise RuntimeError(f"quantized_conv3x3 kernel {kernel}: CUDA error {rc}")
    quantized_conv3x3.launches += 1
    quantized_conv3x3.launches_by_kernel[kernel] += 1
    return out


quantized_conv3x3.launches = 0
quantized_conv3x3.launches_by_kernel = dict.fromkeys(QCONV_KERNEL_CODES, 0)
