"""Command-line interface of the PyTorch port: train / infer / eval.

Counterpart of ``pose_estimation_amitai_tpu/cli.py`` (reference:
tensorflow/train.py:149-153, pytorch/train_pytorch.py:393-397), with its
arguments and a ``--device`` that defaults to ``cuda`` (there is no
automatic fall-back to the CPU; pass ``--device cpu`` for it):

    python -m pose_estimation_amitai_torch train <config.json>
    python -m pose_estimation_amitai_torch infer <config.json> <ckpt> <data.h5> [out.npz] [--mat]
    python -m pose_estimation_amitai_torch eval  <config.json> <ckpt> <data.h5>

``<ckpt>`` is a run directory or a checkpoint file, the port's ``.pt`` or
the JAX package's msgpack (``Predictor.from_checkpoint``). ``infer`` writes
an .npz with ``points_2d`` (F, 3, K) and, for the per-wing model types with
camera matrices in the file, ``points_3d`` (F', K, 3) and
``points_3d_valid``. ``pretrain``, ``export`` and ``import`` parse their
arguments and raise ``NotImplementedError``: self-supervision is ROADMAP
Queue A item 12, the serving artifact and reference checkpoints item 13.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def cmd_train(args) -> int:
    from .train.trainer import Trainer

    Trainer(args.config, device=args.device).train()
    return 0


def cmd_pretrain(args) -> int:
    raise NotImplementedError(
        "pretrain: self-supervised inpainting is ROADMAP Queue A item 12")


def cmd_export(args) -> int:
    raise NotImplementedError(
        "export: the serving artifact is ROADMAP Queue A item 13")


def cmd_import(args) -> int:
    raise NotImplementedError(
        "import: reference checkpoints are ROADMAP Queue A item 13")


def _preprocessed(args):
    """The training-time preprocessing on the eval/infer file (per-wing
    split, mask repair, per-model reshape), then the predictor."""
    from .config import Config
    from .data.preprocess import Preprocessor
    from .infer import Predictor
    from .models import needs_camera_matrices

    if args.import_reference or args.dim_head is not None:
        raise NotImplementedError(
            "--import-reference / --dim-head: reference checkpoints are "
            "ROADMAP Queue A item 13")
    cfg = Config.from_json(args.config).replace(data_path=args.data, debug_mode=False)
    pre = Preprocessor(cfg)
    pre.do_preprocess()
    cameras = None
    if needs_camera_matrices(cfg.model_type):
        # the samples and crop-adjusted cameras the trainer fed, both wings
        # of each frame (the decomposed DLT cameras, as JAX's cli takes them)
        from .data.pipeline import disentangled_samples

        box, confmaps, *cameras = disentangled_samples(
            cfg.replace(estimate_cameras=False), pre)
    else:
        box = pre.get_box().astype(np.float32)
        confmaps = pre.get_confmaps().astype(np.float32)
    # eval defaults to the exact softmax: its numbers are the accuracy surface
    fast_sm = {"auto": None, "on": True, "off": False}[args.fast_softmax]
    predictor = Predictor.from_checkpoint(
        cfg, args.checkpoint,
        image_shape=tuple(box.shape[1:]),
        num_output_channels=confmaps.shape[-1],
        device=args.device,
        chunk_size=args.chunk_size,
        decode=args.decode,
        use_quantized=args.quantized,
        calibration_frames=box[:32] if args.quantized else None,
        quantized_layers=args.quantized_layers,
        fast_softmax=fast_sm,
        cameras=cameras,
    )
    return cfg, pre, box, confmaps, predictor


def cmd_infer(args) -> int:
    from . import constants as C
    from .infer import lift_to_3d

    cfg, pre, box, _, predictor = _preprocessed(args)
    pts = predictor.predict_movie(box)  # (S, 3, K)
    out = {"points_2d": pts}
    # the 4-camera per-wing sample layout: (2F wing-frames) x cams, lifted
    # through the DLT cameras; the 3-good-camera types drop a
    # frame-dependent camera and cannot be paired with fixed matrices
    per_wing_types = (
        C.MODEL_18_POINTS_PER_WING, C.MODEL_18_POINTS_PER_WING_VIT,
        C.MODEL_18_POINTS_PER_WING_VIT_TO_POINTS, C.GPTNET,
        C.PER_WING_MODEL, C.ALL_POINTS_MODEL, C.ALL_POINTS_MODEL_VIT,
    )
    ncams = 4
    if (cfg.model_type in per_wing_types and pre.camera_matrices is not None
            and pts.shape[0] % ncams == 0):
        per_cam = pts.reshape(-1, ncams, 3, pts.shape[-1])
        pts2d = np.transpose(per_cam[:, :, :2, :], (0, 1, 3, 2))  # (2F, 4, K, 2)
        # frames mixed in from a test file carry made-up offsets: their 3D
        # rows are NaN and flagged in points_3d_valid
        cz_all = pre.get_cropzone_per_wing(allow_invalid=True)[: pts2d.shape[0]]
        cz_valid = pre.get_cropzone_valid_per_wing()[: pts2d.shape[0]]
        pts3d = np.array(lift_to_3d(pts2d, cz_all, pre.camera_matrices,
                                    device=args.device))
        pts3d[~cz_valid] = np.nan
        out["points_3d"] = pts3d
        out["points_3d_valid"] = cz_valid
    dest = args.out or "predictions.npz"
    np.savez(dest, **out)
    written = [dest]
    if args.mat:
        # the MATLAB artifact of the lab's downstream tooling
        # (tensorflow/CallBacks.py:26-27)
        from scipy.io import savemat

        mat_dest = os.path.splitext(dest)[0] + ".mat"
        savemat(mat_dest, {k: np.asarray(v) for k, v in out.items()})
        written.append(mat_dest)
    print("wrote " + " + ".join(written) + ": "
          + ", ".join(f"{k} {v.shape}" for k, v in out.items()))
    return 0


def cmd_eval(args) -> int:
    from .infer import evaluate_l2

    _, _, box, confmaps, predictor = _preprocessed(args)
    stats = evaluate_l2(predictor, box, confmaps)
    stats["softmax"] = ("fast_bf16" if getattr(predictor.model, "fast_softmax", None) is True
                        else "exact")
    print(json.dumps(stats, indent=2))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pose_estimation_amitai_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(s) -> None:
        s.add_argument("--device", default="cuda",
                       help="where the model runs (default cuda; cpu for the CPU)")

    t = sub.add_parser("train", help="supervised training")
    t.add_argument("config")
    device_arg(t)
    t.set_defaults(fn=cmd_train)

    pre = sub.add_parser("pretrain", help="self-supervised inpainting (item 12)")
    pre.add_argument("config")
    pre.add_argument("data", nargs="?", default="")
    pre.set_defaults(fn=cmd_pretrain)

    for name, fn in (("infer", cmd_infer), ("eval", cmd_eval)):
        s = sub.add_parser(name)
        s.add_argument("config")
        s.add_argument("checkpoint")
        s.add_argument("data")
        if name == "infer":
            s.add_argument("out", nargs="?", default="")
        s.add_argument("--chunk-size", type=int, default=256)
        s.add_argument("--decode", choices=("argmax", "soft", "refined"), default="argmax",
                       help="peak decoder: hard argmax, soft-argmax, or sub-pixel "
                            "log-parabola refinement")
        s.add_argument("--quantized", action="store_true",
                       help="calibrated int8 serving (int8_generic off the flagship "
                            "geometry)")
        s.add_argument("--quantized-layers", choices=("all", "conv_only"), default=None,
                       help="with --quantized: 'conv_only' keeps a ViT's transformer "
                            "trunk in bf16 and runs its conv decoder on int8")
        s.add_argument("--dim-head", type=int, default=None,
                       help="head width of imported torch ViT checkpoints (item 13; raises)")
        s.add_argument("--fast-softmax", choices=("auto", "on", "off"),
                       default=("off" if name == "eval" else "auto"),
                       help="ViT bf16 softmax chain; 'auto' engages it for argmax "
                            "peaks-only serving; eval defaults to 'off'")
        s.add_argument("--import-reference", action="store_true",
                       help="treat <checkpoint> as a reference checkpoint (item 13; raises)")
        if name == "infer":
            s.add_argument("--mat", action="store_true",
                           help="also write a MATLAB .mat next to the .npz")
        device_arg(s)
        s.set_defaults(fn=fn)

    e = sub.add_parser("export", help="serving artifact (item 13)")
    e.add_argument("config")
    e.add_argument("checkpoint")
    e.add_argument("out")
    e.add_argument("--chunk-size", type=int, default=256)
    e.add_argument("--decode", choices=("argmax", "soft", "refined"), default="argmax")
    e.add_argument("--quantized", action="store_true")
    e.add_argument("--quantized-layers", choices=("all", "conv_only"), default=None)
    e.add_argument("--data", default="")
    e.add_argument("--image-shape", type=int, nargs=3, default=(192, 192, 4),
                   metavar=("H", "W", "C"))
    e.add_argument("--out-channels", type=int, default=18)
    e.set_defaults(fn=cmd_export)

    imp = sub.add_parser("import", help="convert a reference checkpoint (item 13)")
    imp.add_argument("checkpoint")
    imp.add_argument("out")
    imp.add_argument("--dim-head", type=int, default=None)
    imp.set_defaults(fn=cmd_import)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
