"""Host-side training control: plateau LR decay and early stopping
(counterpart of `vitiq/train/schedule.py`).

* ReduceLROnPlateau(mode='min', factor=0.5, patience=5): torch semantics,
  with the relative improvement threshold (1e-4) and patience counted in
  non-improving epochs.
* EarlyStopping(patience=10): score = -val_loss; stop after `patience`
  epochs without improvement. Best parameters are kept as detached clones
  of a model's `state_dict`, never as live references.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ReduceLROnPlateau:
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4  # torch default, relative mode
    min_lr: float = 0.0

    best: Optional[float] = None
    num_bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed one epoch's val metric; returns the (possibly reduced) lr."""
        if self.best is None or metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return lr

    def state_dict(self) -> Dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: Dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


@dataclass
class EarlyStopping:
    patience: int = 10
    delta: float = 0.0
    verbose: bool = False

    best_score: Optional[float] = None
    counter: int = 0
    early_stop: bool = False
    best_params: Any = field(default=None, repr=False)

    def __call__(self, val_loss: float, params: Optional[Dict[str, Any]] = None) -> bool:
        """`params` is a state dict; its tensors are snapshotted."""
        score = -val_loss
        if self.best_score is None or score > self.best_score + self.delta:
            self.best_score = score
            self.counter = 0
            if params is not None:
                self.best_params = {k: v.detach().clone() for k, v in params.items()}
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop

    def state_dict(self) -> Dict:
        return {"best_score": self.best_score, "counter": self.counter,
                "early_stop": self.early_stop}

    def load_state_dict(self, d: Dict) -> None:
        self.best_score = d["best_score"]
        self.counter = d["counter"]
        self.early_stop = d["early_stop"]
