"""pose_estimation_amitai_torch — the PyTorch / NVIDIA Hopper port.

Grows slice by slice beside ``pose_estimation_amitai_tpu`` (the JAX
reference, which it never imports). This slice serves the flagship per-wing
model (``MODEL_18_POINTS_PER_WING``): NHWC frames -> ``BasicNet`` (torch
flavour) -> (B, H, W, K) heatmaps -> (B, 3, K) [x, y, val] peaks -> DLT 3D
lifting. The ``fused`` serving route runs the encoder stages and the decoder
through hand-written CUDA kernels for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"

from .config import Config  # noqa: F401
