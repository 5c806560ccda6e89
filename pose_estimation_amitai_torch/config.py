"""Typed training configuration (PyTorch port).

Field for field the same as ``pose_estimation_amitai_tpu.config`` — a copy,
because the port must not import the JAX package; tests/test_torch_config.py
holds the two together.

The reference drives everything off one flat JSON dict passed as ``sys.argv[1]``
(reference: tensorflow/train.py:149-153, pytorch/train_pytorch.py:393-397) with
pseudo-comment keys spelled ``"// ... //"`` and booleans encoded as 0/1 ints
(tensorflow/train_config.json). This module replaces that with a frozen
dataclass that can still *ingest* the reference JSON dialect verbatim, so the
reference's config files run unmodified.

Key-name drift between the two reference stacks (``patch_size`` vs
``patch size``; ``accumulation_steps`` only in the PyTorch config,
pytorch/train_config.json:14) is normalised here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

from . import constants as C


def _is_comment_key(key: str) -> bool:
    return key.strip().startswith("//")


# Aliases: canonical field name -> accepted JSON spellings (first match wins).
_ALIASES: dict[str, tuple[str, ...]] = {
    "debug_mode": ("debug mode", "debug_mode"),
    "batch_size": ("batch_size", "batch size"),
    "epochs": ("epochs",),
    "batches_per_epoch": ("batches per epoch", "batches_per_epoch"),
    "do_curriculum_learning": ("do curriculum learning",),
    "loss_function": ("loss_function", "loss function"),
    "epochs_pointwise_loss": ("epochs pointwise loss",),
    "val_fraction": ("val_fraction", "val fraction"),
    "learning_rate": ("learning rate", "learning_rate"),
    "accumulation_steps": ("accumulation_steps", "accumulation steps"),
    "dropout_ratio": ("dropout ratio",),
    "dilation_rate": ("dilation rate",),
    "optimizer": ("optimizer",),
    "num_base_filters": ("number of base filters",),
    "num_blocks": ("number of encoder decoder blocks",),
    "kernel_size": ("convolution kernel size",),
    "do_attention": ("do_attention",),
    "patch_size": ("patch size", "patch_size"),
    "projection_dim": ("projection dim", "projection_dim"),
    "num_heads": ("num heads", "num_heads"),
    "dim_head": ("dim head", "dim_head"),
    "transformer_layers": ("transformer layers", "transformer_layers"),
    "fully_connected_expand": ("fully connected expand", "fully_connected_expand"),
    "rank_wing_size": ("rank wing size",),
    "model_type": ("model type", "model_type"),
    "test_path": ("test_path",),
    "data_path": ("data_path", "data path"),
    "mix_with_test": ("mix_with_test",),
    "mask_dilation": ("mask dilation",),
    "ensure_3d_consistency": ("ensure 3d consistency",
                              "ensure_3d_consistency"),
    "single_time_channel": ("single time channel",),
    "do_augmentations": ("do augmentations",),
    "xy_shifts": ("augmentation shift x y",),
    "rotation_range": ("rotation range",),
    "seed": ("seed",),
    "horizontal_flip": ("horizontal flip",),
    "vertical_flip": ("vertical flip",),
    "shear_range": ("shear_range",),
    "zoom_range": ("zoom range",),
    "interpolation_order": ("interpolation order",),
    "wings_masks_dilation": ("wings_masks_dilation",),
    "base_output_path": ("base output path",),
    "clean": ("clean",),
    "reduce_lr_factor": ("reduce_lr_factor",),
    "reduce_lr_patience": ("reduce_lr_patience",),
    "reduce_lr_min_delta": ("reduce_lr_min_delta",),
    "reduce_lr_cooldown": ("reduce_lr_cooldown",),
    "reduce_lr_min_lr": ("reduce_lr_min_lr",),
    "save_every_epoch": ("save_every_epoch",),
    # TPU-rebuild-only knobs (absent from the reference dialect).
    "checkpoint_every": ("checkpoint_every",),
    "async_checkpoint": ("async_checkpoint",),
    "best_min_rel_delta": ("best_min_rel_delta",),
    "compute_dtype": ("compute_dtype",),
    "arch_flavor": ("arch_flavor",),
    "resnet_flavor": ("resnet_flavor",),
    "mesh_shape": ("mesh_shape",),
    "pipeline_stages": ("pipeline_stages", "pipeline stages"),
    "pipeline_microbatches": ("pipeline_microbatches", "pipeline microbatches"),
    "resume_from": ("resume_from",),
    "coarse_model_path": ("coarse_model_path",),
    "pretrained_encoder_path": ("pretrained_encoder_path",),
    "sigma": ("sigma",),
    "profile": ("profile",),
    "nan_debug": ("nan_debug",),
    "host_resident_data": ("host_resident_data",),
    "device_dataset_budget_mb": ("device_dataset_budget_mb",),
    "estimate_cameras": ("estimate_cameras", "estimate cameras"),
    "distributed": ("distributed",),
    "eval_decode": ("eval_decode",),
    "viz_every": ("viz_every",),
    "head_zero_init": ("head_zero_init",),
}


@dataclass(frozen=True)
class Config:
    """Frozen, typed view of a training configuration.

    Field-for-field coverage of both reference config dialects
    (tensorflow/train_config.json, pytorch/train_config.json).
    """

    # --- training ---
    debug_mode: bool = False
    batch_size: int = 8
    epochs: int = 50
    batches_per_epoch: int = 10
    do_curriculum_learning: bool = False
    loss_function: str = "mean_squared_error"
    epochs_pointwise_loss: int = 0
    val_fraction: float = 0.5
    learning_rate: float = 1e-3
    accumulation_steps: int = 1
    # --- network ---
    dropout_ratio: float = 0.5
    dilation_rate: int = 2
    optimizer: str = "adam"
    num_base_filters: int = 64
    num_blocks: int = 2
    kernel_size: int = 3
    do_attention: bool = False
    # --- ViT ---
    patch_size: int = 16
    projection_dim: int = 256
    num_heads: int = 8
    dim_head: int = -1
    transformer_layers: int = 8
    fully_connected_expand: int = 4
    # --- preprocess ---
    rank_wing_size: int = 2
    model_type: str = C.MODEL_18_POINTS_PER_WING
    test_path: str = "-"
    data_path: str = "-"
    mix_with_test: bool = False
    mask_dilation: int = 1
    # 3D left/right consistency repair during per-wing preprocess. The
    # reference implemented the checker but left it commented out at the
    # call site (pytorch/preprocessor.py:237-241) — default off keeps
    # reference parity; on, the best flip mask (8 combos of cameras 1-3
    # scored by multi-view reprojection error) is APPLIED to the wing
    # masks/confmaps before the per-wing reshape.
    ensure_3d_consistency: bool = False
    single_time_channel: bool = False
    # --- augmentation ---
    do_augmentations: bool = True
    xy_shifts: float = 10.0
    rotation_range: float = 30.0
    seed: int = 1
    horizontal_flip: bool = True
    vertical_flip: bool = True
    shear_range: float = 0.0
    zoom_range: tuple[float, float] = (1.0, 1.0)
    interpolation_order: int = 1
    wings_masks_dilation: int = 0
    # --- saving ---
    base_output_path: str = "models"
    clean: bool = False
    # --- callbacks (ReduceLROnPlateau, tensorflow/CallBacks.py:118-121) ---
    reduce_lr_factor: float = 0.1
    reduce_lr_patience: int = 3
    reduce_lr_min_delta: float = 1e-5
    reduce_lr_cooldown: int = 0
    reduce_lr_min_lr: float = 1e-10
    save_every_epoch: bool = False
    # --- TPU rebuild extensions ---
    # resume-checkpoint cadence in epochs (1 = reference parity: the every-
    # epoch checkpoint.pth, pytorch/train_pytorch.py:253-260; raise it for
    # short-epoch regimes where the ~per-epoch params serialisation
    # dominates wall time — best-on-val checkpoints are unaffected)
    checkpoint_every: int = 1
    # write checkpoints from a background thread (the device->host fetch +
    # msgpack encode overlap the next epoch's dispatched work; saves stay
    # atomic and ordered — train/checkpoint.py AsyncCheckpointer)
    async_checkpoint: bool = True
    # min RELATIVE val-loss improvement that triggers a best-model write
    # (0 = reference parity: every improvement writes, pytorch/
    # train_pytorch.py:177-181). On a steadily-descending curve every epoch
    # writes a full-state snapshot — through a remote-attached runtime that
    # device->host fetch can dominate short-epoch regimes; e.g. 0.01 writes
    # only on >=1% improvements. The in-memory best marker (and the metric
    # printed/logged) still updates on EVERY improvement.
    best_min_rel_delta: float = 0.0
    compute_dtype: str = "bfloat16"  # bf16 compute / f32 params (no AMP scaler)
    arch_flavor: str = "torch"  # 'torch' | 'tf': pins LeakyReLU alpha + skips
    # ResNet50 trunk flavour: 'tpu' (XLA-SAME pads, the benched default),
    # 'torch' (torchvision-exact pads — REQUIRED for bit-exact ImageNet
    # encoder init via pretrained_encoder_path -> torchvision state_dict),
    # 'tf' (keras-applications-exact v1 trunk, for imported reference .h5)
    resnet_flavor: str = "tpu"
    mesh_shape: tuple[int, ...] = ()  # () => 1-D data mesh over all devices
    # GPipe pipeline parallelism over the ViT trunk (parallel/pipeline.py):
    # >1 => train on a (data, pipe) mesh with the transformer block stack
    # sharded over `pipeline_stages` stages. ViT heatmap family only.
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0  # 0 => one microbatch per stage
    resume_from: str = ""  # checkpoint dir/file to resume training from
    coarse_model_path: str = ""  # C2F: frozen coarse-stage checkpoint
    pretrained_encoder_path: str = ""  # fine-tune after self-supervision
    sigma: float = 3.0  # Gaussian confmap sigma (simple_data_generator.py:120)
    profile: bool = False  # torch.profiler trace around the train loop
    nan_debug: bool = False  # jax debug_nans (analog of detect_anomaly)
    host_resident_data: bool = False  # force the HostDataset streaming feed
    # auto-switch to HostDataset above this estimated dataset size
    device_dataset_budget_mb: int = 8192
    distributed: bool = False  # join a multi-host cluster (jax.distributed)
    # disentangled camera models: estimate per-frame DLT cameras from the
    # ground-truth peaks (tensorflow/Custom_data_generator.py:216-241)
    # instead of decomposing the H5's calibrated cameras_dlt_array — for
    # datasets whose calibration is absent or mistrusted
    estimate_cameras: bool = False
    # val-L2 decoder: 'argmax' (reference parity) or 'refined' (sub-pixel)
    eval_decode: str = "argmax"
    # heavy PNG artifacts (histograms, overlays, curves) every N epochs;
    # 1 = reference parity (every epoch). CSV/MAT metrics are always written.
    viz_every: int = 1
    # zero-init the final heatmap layer so training starts from the exact
    # all-zeros prediction (train/loop.py zero_output_head) — faster plateau
    # escape under aggressive LR schedules; off by default (reference-style
    # library init)
    head_zero_init: bool = False

    raw: dict[str, Any] = field(default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Build a Config from a (possibly reference-dialect) dict."""
        clean = {k: v for k, v in d.items() if not _is_comment_key(k)}
        kwargs: dict[str, Any] = {"raw": dict(clean)}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, aliases in _ALIASES.items():
            for alias in aliases:
                if alias in clean:
                    kwargs[name] = _coerce(fields[name], clean[alias])
                    break
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("raw")
        d["zoom_range"] = list(self.zoom_range)
        d["mesh_shape"] = list(self.mesh_shape)
        return d

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _coerce(f: dataclasses.Field, value: Any) -> Any:
    """Coerce reference-dialect values (0/1 bools, lists) to the field type."""
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
    if t == "bool":
        return bool(value)
    if t == "int":
        return int(value)
    if t == "float":
        return float(value)
    if t == "str":
        return str(value)
    if t.startswith("tuple[float"):
        return tuple(float(v) for v in value)
    if t.startswith("tuple[int") or t.startswith("tuple[int, ...]"):
        return tuple(int(v) for v in value)
    return value
