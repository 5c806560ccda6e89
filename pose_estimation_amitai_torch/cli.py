"""Command-line interface of the PyTorch port: train / pretrain / infer /
eval / export / import.

Counterpart of ``pose_estimation_amitai_tpu/cli.py`` (reference:
tensorflow/train.py:149-153, pytorch/train_pytorch.py:393-397), with its
arguments and a ``--device`` that defaults to ``cuda`` (there is no
automatic fall-back to the CPU; pass ``--device cpu`` for it):

    python -m pose_estimation_amitai_torch train <config.json>
    python -m pose_estimation_amitai_torch pretrain <config.json> [crops_dir | data.h5]
    python -m pose_estimation_amitai_torch infer <config.json> <ckpt> <data.h5> [out.npz] [--mat]
    python -m pose_estimation_amitai_torch eval  <config.json> <ckpt> <data.h5>
    python -m pose_estimation_amitai_torch export <config.json> <ckpt> <out.ptexp>
    python -m pose_estimation_amitai_torch import <reference ckpt> <out.pt>

``<ckpt>`` is a run directory or a checkpoint file: the port's ``.pt``, the
JAX package's msgpack, a reference checkpoint (keras ``.h5``, torch
``.pth``; detected by its content, or forced with ``--import-reference``) or
a ``cli import`` snapshot (``Predictor.from_checkpoint``). ``infer`` writes
an .npz with ``points_2d`` (F, 3, K) and, for the per-wing model types with
camera matrices in the file, ``points_3d`` (F', K, 3) and
``points_3d_valid``. ``pretrain`` runs self-supervised inpainting
(train/selfsup.py), ``export`` writes the serving artifact (deploy.py),
``import`` converts a reference checkpoint to a self-describing snapshot
(importers.py).
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
    from .train import selfsup

    selfsup.main([args.config] + ([args.data] if args.data else []), device=args.device)
    return 0


def cmd_export(args) -> int:
    """Write a self-contained serving artifact (deploy.py) -- the
    counterpart of the reference's TorchScript ``best_model.pth``
    (pytorch/train_pytorch.py:177-181) -- for the device type of
    ``--device``."""
    from .config import Config
    from .deploy import export_predictor
    from .infer import Predictor

    cfg = Config.from_json(args.config)
    calibration = None
    image_shape = tuple(args.image_shape)
    if args.quantized:
        if args.data:
            from .data.preprocess import Preprocessor

            pre = Preprocessor(cfg.replace(data_path=args.data, debug_mode=False))
            pre.do_preprocess()
            calibration = pre.get_box().astype(np.float32)[:32]
            image_shape = tuple(calibration.shape[1:])
        else:
            # shape-only calibration (uniform [0, 1) like normalised frames);
            # pass real data for production scales
            calibration = np.random.default_rng(0).random(
                (32, *image_shape), dtype=np.float32)
    predictor = Predictor.from_checkpoint(
        cfg, args.checkpoint,
        image_shape=image_shape,
        num_output_channels=args.out_channels,
        device=args.device,
        chunk_size=args.chunk_size,
        decode=args.decode,
        use_quantized=args.quantized,
        calibration_frames=calibration,
        quantized_layers=args.quantized_layers,
    )
    header = export_predictor(predictor, args.out)
    print(json.dumps(header))
    return 0


def cmd_import(args) -> int:
    """Convert a reference checkpoint to the port's self-describing
    snapshot: params, BatchNorm statistics and the architecture
    (importers.save_imported_snapshot), which ``Predictor.from_checkpoint``
    and ``pretrained_encoder_path`` read."""
    from .importers import import_reference_checkpoint, save_imported_snapshot

    imported = import_reference_checkpoint(args.checkpoint, dim_head=args.dim_head)
    save_imported_snapshot(imported, args.out)
    print(json.dumps({
        "written": args.out,
        "format": "imported_reference_v1",
        "model_kind": imported.model_kind,
        "arch_flavor": imported.arch_flavor,
        "arch_kwargs": imported.arch_kwargs,
        "has_batch_stats": bool(imported.batch_stats),
    }))
    return 0


def _preprocessed(args):
    """The training-time preprocessing on the eval/infer file (per-wing
    split, mask repair, per-model reshape), then the predictor."""
    from .config import Config
    from .data.preprocess import Preprocessor
    from .infer import Predictor
    from .models import needs_camera_matrices

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
        import_reference=args.import_reference,
        dim_head=args.dim_head,
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

    pre = sub.add_parser("pretrain", help="self-supervised inpainting")
    pre.add_argument("config")
    pre.add_argument("data", nargs="?", default="",
                     help="a directory of .npy crops or an H5 file's box array "
                          "(default: the config's data path)")
    device_arg(pre)
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
                       help="head width of an imported torch ViT checkpoint (only "
                            "the product heads x dim_head is in its shapes)")
        s.add_argument("--fast-softmax", choices=("auto", "on", "off"),
                       default=("off" if name == "eval" else "auto"),
                       help="ViT bf16 softmax chain; 'auto' engages it for argmax "
                            "peaks-only serving; eval defaults to 'off'")
        s.add_argument("--import-reference", action="store_true",
                       help="treat <checkpoint> as a reference checkpoint (keras "
                            ".h5 / torch .pth); detected by content otherwise")
        if name == "infer":
            s.add_argument("--mat", action="store_true",
                           help="also write a MATLAB .mat next to the .npz")
        device_arg(s)
        s.set_defaults(fn=fn)

    e = sub.add_parser("export", help="serving artifact (torch.export program + header)")
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
    device_arg(e)
    e.set_defaults(fn=cmd_export)

    imp = sub.add_parser("import", help="convert a reference checkpoint to a snapshot")
    imp.add_argument("checkpoint", help="reference checkpoint file")
    imp.add_argument("out", help="output snapshot path (.pt)")
    imp.add_argument("--dim-head", type=int, default=None,
                     help="head width of a torch ViT checkpoint")
    imp.set_defaults(fn=cmd_import)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
