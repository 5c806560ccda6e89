"""Checkpoints with true resume (PyTorch port).

Counterpart of ``pose_estimation_amitai_tpu/train/checkpoint.py`` in the
port's own format: ``torch.save`` files (the JAX package writes flax
msgpack), named as JAX names them with the port's suffix --
``checkpoint.pt`` (the full training state, every-epoch policy,
pytorch/train_pytorch.py:253-260), ``best_model.pt`` -- beside the same
``checkpoint_meta.json`` (epoch, val_loss, best_loss, scheduler). A restored
state continues exactly where the saved one stopped: parameters, Adam
state, step, seed and the BatchNorm running averages are all there is, since
the step's draws derive from (seed, step). A weights-only snapshot
(``save_params``) is the module's ``state_dict``: the parameters and, for
the BatchNorm families, the running averages beside them. Parameters of a JAX checkpoint load through
``weights.load_flax_checkpoint`` and ``weights.basicnet_state_dict``.

Files are written to a temporary name and moved into place
(``os.replace``), so a crash never leaves a truncated one. They are read
with ``weights_only=True``: only tensors and plain containers load.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

from ..weights import split_stats
from .loop import TrainState

CHECKPOINT_NAME = "checkpoint.pt"
BEST_NAME = "best_model.pt"
META_NAME = "checkpoint_meta.json"


def _cpu(tree):
    """``tree`` with every tensor copied to the host."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write(path: str, payload) -> str:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _state_payload(state: TrainState) -> dict:
    return _cpu({"step": state.step, "params": state.params,
                 "opt_state": state.opt_state, "seed": state.seed,
                 "batch_stats": state.batch_stats})


def save_checkpoint(
    run_path: str,
    state: TrainState,
    epoch: int,
    val_loss: float,
    scheduler_state: dict[str, Any] | None = None,
    best: bool = False,
    best_loss: float | None = None,
) -> str:
    """Write the full training state to ``run_path`` (``best``: the
    best-model snapshot, and no meta). The meta's ``best_loss`` is the best
    val loss so far, so a resumed run keeps the true best marker."""
    path = _write(os.path.join(run_path, BEST_NAME if best else CHECKPOINT_NAME),
                  _state_payload(state))
    if not best:
        meta = {
            "epoch": int(epoch),
            "val_loss": float(val_loss),
            "best_loss": float(val_loss if best_loss is None else best_loss),
            "scheduler": scheduler_state or {},
        }
        with open(os.path.join(run_path, META_NAME), "w") as f:
            json.dump(meta, f, indent=2)
    return path


def save_params(
    path: str, params: dict[str, torch.Tensor],
    batch_stats: dict[str, torch.Tensor] | None = None,
) -> str:
    """Weights-only snapshot (the per-epoch weights of the reference,
    tensorflow/CallBacks.py:122-128): the parameters and the running
    averages, one ``state_dict``."""
    return _write(path, _cpu({**params, **(batch_stats or {})}))


class AsyncCheckpointer:
    """Writes checkpoints from a background thread.

    The train step never changes a state it was given, so saving one needs
    only its references: the device-to-host copy, the encoding and the write
    run on a worker while the caller goes on. At most one write is in
    flight (a second save waits for the first), so files land in order.
    ``wait()`` re-raises the worker's error; call it before reading a file
    back."""

    def __init__(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Future | None = None

    def save_checkpoint(self, *args, **kwargs) -> None:
        self.wait()
        self._pending = self._pool.submit(save_checkpoint, *args, **kwargs)

    def save_params(self, path: str, params, batch_stats=None) -> None:
        self.wait()
        self._pending = self._pool.submit(save_params, path, params, batch_stats)

    def wait(self) -> None:
        """Block until the write in flight lands; re-raise its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Wait for the last write, then stop the worker."""
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def _resolve(path: str, names: tuple[str, ...]) -> str:
    """``path`` itself, or the first of ``names`` in the run directory it
    names."""
    if not os.path.isdir(path):
        return path
    for name in names:
        cand = os.path.join(path, name)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"{path}: none of {', '.join(names)} in this run directory")


def load_variables(
    path: str, device: torch.device | str = "cpu"
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(parameters, running averages) from a weights-only snapshot, a full
    checkpoint, or a run directory (``best_model.pt`` preferred), on
    ``device``; the averages are {} for the models without BatchNorm."""
    blob = torch.load(_resolve(path, (BEST_NAME, CHECKPOINT_NAME)),
                      map_location=device, weights_only=True)
    if isinstance(blob, dict) and {"params", "opt_state"} <= set(blob):
        return blob["params"], blob.get("batch_stats", {})
    return split_stats(blob)


def load_params(
    path: str, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """The parameters of :func:`load_variables`."""
    return load_variables(path, device)[0]


def restore_checkpoint(
    path: str, template: TrainState
) -> tuple[TrainState, dict[str, Any]]:
    """The training state saved at ``path`` (a file, or a run directory's
    ``checkpoint.pt``), on the device of ``template``'s parameters, and the
    meta dict ({} where there is none). ``template`` (e.g. a fresh
    ``create_train_state``) must have the same parameter and running
    average names."""
    ckpt = _resolve(path, (CHECKPOINT_NAME,))
    device = next(iter(template.params.values())).device
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    stats = blob.get("batch_stats", {})
    if list(blob["params"]) != list(template.params) or set(stats) != set(
            template.batch_stats):
        raise ValueError(f"{ckpt}: its parameters are not the template's")
    opt_state = blob["opt_state"]
    # Adam's moments live with the parameters; its step counters on the host
    opt_state["state"] = {
        i: {k: v if k == "step" else v.to(device) for k, v in s.items()}
        for i, s in opt_state["state"].items()}
    state = TrainState(
        step=int(blob["step"]),
        params={k: v.to(device) for k, v in blob["params"].items()},
        opt_state=opt_state, seed=int(blob["seed"]),
        batch_stats={k: v.to(device) for k, v in stats.items()})
    meta_path = os.path.join(os.path.dirname(ckpt), META_NAME)
    meta: dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
