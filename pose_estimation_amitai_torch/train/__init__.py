"""Training layer of the port: the train and eval steps, and checkpoints
with true resume. (The ``Trainer`` and its run directory are ROADMAP Queue
A item 8.)"""

from . import checkpoint  # noqa: F401
from .loop import (  # noqa: F401
    PlateauScheduler,
    TrainState,
    create_train_state,
    make_eval_step,
    make_predict_fn,
    make_train_step,
)
