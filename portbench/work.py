"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and
the operations and bytes of convolutions, transposed convolutions, matrix
products and the port's custom serving ops, from shapes.

Operations are 2 x multiply-adds. A stride-2 transposed conv does
``k * k`` multiply-adds per input pixel and channel pair (zero taps are
not work). A kernel's bound is the larger of its operations at the dense
bf16 peak and its bytes (operands read once, output written once) at the
memory peak (``bound`` and ``stage_ops`` are kept as the repository's
``chip_smoke.py`` computes them).
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power limit
PEAK_OPS = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "tf32": 495e12,
            "f32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(ops: float, moved: float, kind: str = "bf16") -> float:
    """The least seconds the card could take for ``ops`` operations of
    ``kind`` and ``moved`` bytes."""
    return max(ops / PEAK_OPS[kind], moved / PEAK_BYTES)


def bound(ops: float, kind: str, moved: int) -> tuple[float, str]:
    """(bound_ms, bound_by), as ``chip_smoke.py`` gives it."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def stage_ops(b: int, h: int, w: int, cin: int, cout: int) -> float:
    """Multiply-adds x 2 of one encoder stage's three 3x3 convs (at the
    stage's input resolution), as ``chip_smoke.py`` counts them."""
    return 2.0 * 9 * b * h * w * (cin * cout + 2 * cout * cout)


def conv_ops(out_pixels: int, k: int, cin: int, cout: int) -> float:
    """2 x multiply-adds of a stride-1 ``k x k`` conv."""
    return 2.0 * out_pixels * k * k * cin * cout


def deconv_ops(in_pixels: int, k: int, cin: int, cout: int) -> float:
    """2 x multiply-adds of a transposed conv: ``k * k`` per input pixel."""
    return 2.0 * in_pixels * k * k * cin * cout


def matmul_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n
