"""Training layer of the port: the train and eval steps, checkpoints with
true resume, and the ``Trainer`` with its run directory (train/trainer.py,
imported on use)."""

from . import checkpoint  # noqa: F401
from .loop import (  # noqa: F401
    PlateauScheduler,
    TrainState,
    create_train_state,
    make_eval_step,
    make_predict_fn,
    make_train_step,
)
