"""Training (counterpart of `vitiq/train`): the steps and `fit` (with
resuming), clip + AdamW, the schedulers, and `checkpoint.py`'s parameter files
and full TrainState checkpoints in `vitiq`'s layout."""

from vitiq_torch.train.optim import TrainState, create_train_state, get_learning_rate, set_learning_rate  # noqa: F401
from vitiq_torch.train.schedule import EarlyStopping, ReduceLROnPlateau  # noqa: F401
from vitiq_torch.train.loop import fit, make_eval_step, make_train_scan_step, make_train_step  # noqa: F401,E501
