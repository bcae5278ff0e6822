"""Losses and metrics (counterpart of `vitiq/ops/metrics.py`).

`label_smoothed_cross_entropy` is torch's `CrossEntropyLoss(label_smoothing=
eps)`: the smoothed target (1-eps)*onehot + eps/K against the log-softmax,
averaged over the batch, always in f32.
"""

from __future__ import annotations

import torch


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def label_smoothed_cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                                            smoothing: float) -> torch.Tensor:
    """[B] label-smoothed CE (counterpart of `vitiq/train/loop.py:
    label_smoothed_cross_entropy_per_sample`)."""
    logp = log_softmax(logits.float())
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if smoothing == 0.0:
        return nll
    uniform = -logp.mean(dim=-1)  # expected NLL under the uniform target
    return (1.0 - smoothing) * nll + smoothing * uniform


def label_smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 smoothing: float = 0.1) -> torch.Tensor:
    """Mean label-smoothed CE over the batch. logits [B, K], labels [B] int."""
    return label_smoothed_cross_entropy_per_sample(logits, labels, smoothing).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
