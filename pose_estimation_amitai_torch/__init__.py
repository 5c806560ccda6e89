"""pose_estimation_amitai_torch — the PyTorch / NVIDIA Hopper port.

Grows slice by slice beside ``pose_estimation_amitai_tpu`` (the JAX
reference, which it never imports). So far it serves the flagship per-wing
model (``MODEL_18_POINTS_PER_WING``, in bf16 and in calibrated int8) and the
ViT families (``ViTPoseNet``, ``ViT4Cameras``): NHWC frames -> model ->
(B, H, W, K) heatmaps -> (B, 3, K) [x, y, val] peaks -> DLT 3D lifting. The
``fused`` serving routes run the flagship's encoder stages and decoder, its
int8 encoder stages, and the ViT's attention cores through hand-written CUDA
kernels for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(``ops/_build.py``). It also trains the flagship model: the data layer
(``data/``), on-device augmentation and target rendering, the train and eval
steps and checkpoints with true resume (``train/``).
"""

__version__ = "0.1.0"

from .config import Config  # noqa: F401
