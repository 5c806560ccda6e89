"""Fused torch-flavour transposed-conv decoder: Hopper kernel and plain
version.

Counterpart of ``pose_estimation_amitai_tpu/ops/pallas_deconv.py``. The
flagship decoder (reference: pytorch/CNNs.py:92-157)

    t1 = LReLU(up2(latent, W1) + b1)            cin -> mid
    t2 = LReLU(s1(t1, W2) + b2) + t1
    t3 = LReLU(s1(t2, W3) + b3) + t2
    y  = LReLU(up2(t3, W4) + b4)                mid -> K

on flax ConvTranspose HWIO kernels: ``s1`` is flax's stride-1
ConvTranspose(SAME), an unflipped SAME correlation; ``up2`` is the
torch-flavour stride-2 layer, y[2j] = x[j] W[1], y[2j+1] = x[j] W[0] +
x[j+1] W[2] per axis, which is ``ConvTranspose2d(k3, s2, padding=1,
output_padding=1)`` with the kernel flipped in space. Intermediates are
rounded to the latent's dtype, as the TPU kernel's scratch holds them.

On a CUDA tensor :func:`fused_decoder` launches ``csrc/decoder.cu``; on a
CPU tensor it runs :func:`fused_decoder_plain`. Any cin, mid and K.

Each stride-2 layer runs one of two kernels, and :func:`up2_kernel_for`
chooses from dtype and shape alone: ``"mma"``, four phase GEMMs on the bf16
tensor cores (``csrc/deconv_mma.cuh``; bfloat16, input channels a multiple
of 16), or ``"fma"``, f32 FMAs on the CUDA cores (float32, where TF32 would
break the 1e-4 limit, and every other shape). Both follow one tap table,
:data:`UP2_TAP_SHIFT` and :data:`UP2_TAP_PARITY`, which
:func:`up2_polyphase_plain` spells out in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .hopper_conv import (
    CONV_KERNEL_CODES, DTYPE_CODES, SMEM_MAX, bias_nchw, check_input,
    check_operand, conv_kernel_for, lrelu,
)

UP2_KERNEL_CODES = {"fma": 0, "mma": 1}
# The stride-2 layer's tap table, per axis (csrc/deconv_mma.cuh: up2_shift,
# up2_parity): y[2j] = x[j] W[1], y[2j+1] = x[j] W[0] + x[j+1] W[2], so tap k
# reads the input at j + UP2_TAP_SHIFT[k] and writes the output of parity
# UP2_TAP_PARITY[k].
UP2_TAP_SHIFT = (0, 0, 1)
UP2_TAP_PARITY = (1, 0, 1)
# the tensor-core kernel's tiling (csrc/deconv_mma.cuh)
UP2_MMA_ROWS = 8  # input rows of a block
UP2_MMA_COLS = 16  # input columns of a block
UP2_MMA_COUT = 32  # output channels of a block
UP2_MMA_CIN = 16  # input channels of a staged chunk
UP2_MMA_STAGES = 3  # ring depth


def up2_mma_smem_bytes() -> int:
    """Shared memory a block of the ``"mma"`` stride-2 kernel asks for: the
    larger of its ring (three stages of the 9 x 17 patch at 32 bytes a pixel
    and the 9 x 16 x 32 bf16 weight slab, and a 4-byte table entry a patch
    pixel) and the bf16 output tile (16 x 32 pixels, 32 + 8 channels). The
    kernel's own figure is :func:`up2_mma_smem_bytes_built`; the card's
    tests hold the two equal."""
    npix = (UP2_MMA_ROWS + 1) * (UP2_MMA_COLS + 1)
    ring = (UP2_MMA_STAGES * (32 * npix + 2 * 9 * UP2_MMA_CIN * UP2_MMA_COUT)
            + 4 * npix)
    tile = 2 * (2 * UP2_MMA_ROWS) * (2 * UP2_MMA_COLS) * (UP2_MMA_COUT + 8)
    return max(ring, tile)


def up2_kernel_for(dtype: torch.dtype, cin: int, cout: int) -> str:
    """Which kernel a CUDA stride-2 layer of this dtype and shape launches:
    ``"mma"`` or ``"fma"``. A rule on dtype and shape only; the tensor-core
    kernel takes any ``cout`` (it zero fills its last channel tile)."""
    if (dtype == torch.bfloat16 and cout >= 1 and cin >= UP2_MMA_CIN
            and cin % UP2_MMA_CIN == 0 and up2_mma_smem_bytes() <= SMEM_MAX):
        return "mma"
    return "fma"


def _s1(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """flax stride-1 ConvTranspose(SAME), k3: unflipped SAME correlation."""
    return F.conv2d(x, w_hwio.float().permute(3, 2, 0, 1), padding=1)


def _up2(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """torch-flavour stride-2 ConvTranspose on a flax HWIO kernel."""
    w = torch.flip(w_hwio.float(), (0, 1)).permute(2, 3, 0, 1)  # (I, O, kh, kw)
    return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)


def up2_polyphase_plain(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """:func:`_up2` as the kernels compute it: the four output phases as
    products of the input and its right, lower and lower-right neighbours
    (zero beyond the edge) with the taps the table assigns them, interleaved.
    NCHW float32 ``x``, flax HWIO kernel."""
    b, _, r, wd = x.shape
    w = w_hwio.float()
    xp = F.pad(x, (0, 1, 0, 1))  # one zero column to the right, one row below
    y = x.new_zeros((b, w.shape[-1], 2 * r, 2 * wd))
    for ky in range(3):
        for kx in range(3):
            dy, dx = UP2_TAP_SHIFT[ky], UP2_TAP_SHIFT[kx]
            a, c = UP2_TAP_PARITY[ky], UP2_TAP_PARITY[kx]
            y[:, :, a::2, c::2] += torch.einsum(
                "bihw,io->bohw", xp[:, :, dy : dy + r, dx : dx + wd], w[ky, kx])
    return y


def fused_decoder_plain(
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decoder` (f32 compute,
    intermediates rounded to the latent's dtype), any device."""
    dt = latent.dtype
    h = latent.permute(0, 3, 1, 2).float()
    t1 = lrelu(_up2(h, w1) + bias_nchw(b1), alpha).to(dt).float()
    t2 = (lrelu(_s1(t1, w2) + bias_nchw(b2), alpha) + t1).to(dt).float()
    t3 = (lrelu(_s1(t2, w3) + bias_nchw(b3), alpha) + t2).to(dt).float()
    y = lrelu(_up2(t3, w4) + bias_nchw(b4), alpha)
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder")
    fn = lib.pe_fused_decoder
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 12 + [i] * 6 + [ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.pe_up2_mma_smem_bytes.argtypes = []
        lib.pe_up2_mma_smem_bytes.restype = ctypes.c_longlong
    return lib


def up2_mma_smem_bytes_built() -> int:
    """The same figure from the built library: what the launch asks for."""
    return _lib().pe_up2_mma_smem_bytes()


def fused_decoder(
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """Fused torch-flavour DecoderUp: (B, R, W, cin) -> (B, 4R, 4W, K) in
    the latent's dtype.

    Weights are flax ConvTranspose HWIO kernels in the latent's dtype,
    biases float32. CUDA tensors run the ``csrc/decoder.cu`` kernels (four
    launches writing the interleaved output directly, intermediates in a
    workspace the wrapper allocates); CPU tensors run the plain version. The
    two stride-1 convs run the kernel ``hopper_conv.conv_kernel_for`` names
    for (mid -> mid, dilation 1): ``"wgmma"`` on the tensor cores in bfloat16
    when mid is a multiple of 16. The two stride-2 layers run the kernel
    :func:`up2_kernel_for` names for (cin -> mid) and (mid -> K). Each kernel
    run adds one to ``fused_decoder.launches``, its two convs to
    ``fused_decoder.convs_by_kernel`` and its two stride-2 layers to
    ``fused_decoder.up2_by_kernel``.
    """
    if latent.device.type == "cpu":
        return fused_decoder_plain(
            latent, w1, b1, w2, b2, w3, b3, w4, b4, alpha=alpha
        )
    cin, mid, k = latent.shape[-1], w1.shape[-1], w4.shape[-1]
    dt = latent.dtype
    return fused_decoder_on(
        conv_kernel_for(dt, mid, mid, 1),
        (up2_kernel_for(dt, cin, mid), up2_kernel_for(dt, mid, k)),
        latent, w1, b1, w2, b2, w3, b3, w4, b4, alpha=alpha)


def fused_decoder_on(
    conv_kernel: str,
    up2_kernels: tuple[str, str],
    latent: torch.Tensor,
    w1, b1, w2, b2, w3, b3, w4, b4,
    *,
    alpha: float = 0.1,
) -> torch.Tensor:
    """:func:`fused_decoder` on CUDA tensors with the kernel of the two
    stride-1 convs and of each stride-2 layer (first, head) named by the
    caller: the one ``conv_kernel_for`` or :func:`up2_kernel_for` names, or
    ``"fma"``, which takes every shape (to time one kernel against the other
    on the same tensors). Raises for any other choice."""
    cin, mid, k = latent.shape[-1], w1.shape[-1], w4.shape[-1]
    dt, dev = latent.dtype, latent.device
    if conv_kernel not in ("fma", conv_kernel_for(dt, mid, mid, 1)):
        raise ValueError(f"kernel {conv_kernel!r} does not take {dt} {mid} -> {mid} channels")
    for name, ci, co in zip(up2_kernels, (cin, mid), (mid, k), strict=True):
        if name not in ("fma", up2_kernel_for(dt, ci, co)):
            raise ValueError(
                f"stride-2 kernel {name!r} does not take {dt} {ci} -> {co} channels")
    check_input(latent)
    b, r, wd, _ = latent.shape
    check_operand("w1", w1, (3, 3, cin, mid), dt, dev)
    check_operand("w2", w2, (3, 3, mid, mid), dt, dev)
    check_operand("w3", w3, (3, 3, mid, mid), dt, dev)
    check_operand("w4", w4, (3, 3, mid, k), dt, dev)
    for name, bias, n in (("b1", b1, mid), ("b2", b2, mid), ("b3", b3, mid),
                          ("b4", b4, k)):
        check_operand(name, bias, (n,), torch.float32, dev)
    if 4 * r * wd >= 2 ** 31:
        raise ValueError(f"{2 * r}x{2 * wd} pixels a map: the kernels index them in 32 bits")
    ws1 = torch.empty((b, 2 * r, 2 * wd, mid), dtype=dt, device=dev)
    ws2 = torch.empty((b, 2 * r, 2 * wd, mid), dtype=dt, device=dev)
    out = torch.empty((b, 4 * r, 4 * wd, k), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().pe_fused_decoder(
            DTYPE_CODES[dt], latent.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), w4.data_ptr(), b4.data_ptr(),
            ws1.data_ptr(), ws2.data_ptr(), out.data_ptr(),
            b, r, wd, cin, mid, k, alpha, CONV_KERNEL_CODES[conv_kernel],
            *(UP2_KERNEL_CODES[n] for n in up2_kernels), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_decoder kernel: CUDA error {rc}")
    fused_decoder.launches += 1
    fused_decoder.convs_by_kernel[conv_kernel] += 2
    for name in up2_kernels:
        fused_decoder.up2_by_kernel[name] += 1
    return out


fused_decoder.launches = 0
fused_decoder.convs_by_kernel = {"fma": 0, "wgmma": 0}
fused_decoder.up2_by_kernel = dict.fromkeys(UP2_KERNEL_CODES, 0)
