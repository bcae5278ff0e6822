"""The softmax calibration guard (counterpart of `vitiq/ops/guards.py`).

The JAX package's fused TPU kernels exponentiate the raw scaled scores
without subtracting the row max, which holds while |score| stays below the
float32 exp's overflow (~88.7). `max_abs_attention_score` measures the peak
|scaled pre-softmax score| of a model's weights over a calibration batch,
and `check_softmax_bound` warns (or raises) where it passes the bound.

The port's kernels (K1, K2, K5, K7) all subtract the row max, so they do not
need the guard: it guards the weights' exports to the JAX package's TPU
kernels (the parameter files of `train/checkpoint.py` and the reference
``.pth``, which either package reads) and f32 `exp`, not the port's own
kernels. It runs the model's f32 `reference` path, which is cheap to call
when a checkpoint is imported (`interop.load_torch_checkpoint`).
"""

from __future__ import annotations

import math
import warnings
from typing import List

import numpy as np
import torch

from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.ops.numerics import REFERENCE

# f32 exp overflows at ~88.7; the bound keeps a margin below it
SAFE_SCORE_BOUND = 80.0


def max_abs_attention_score(model, src) -> float:
    """Largest |scaled pre-softmax score| over all layers and heads for
    `src` (an `AMCModel`'s preprocessed input: [B, 1, H, W] for the ViT arm,
    [B, C, L] for rawIQ): the model's encoder in eval mode on the f32
    `reference` path, with an attention function that records each layer's
    peak."""
    peaks: List[float] = []

    def capturing(q, k, v, mask=None, policy=REFERENCE):
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        peaks.append(scores.abs().max().item() / math.sqrt(q.shape[-1]))
        return scaled_dot_product_attention(q, k, v, mask=mask, policy=policy)

    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model.encoder(torch.as_tensor(src, dtype=torch.float32, device=device), REFERENCE,
                          attention_fn=capturing)
    finally:
        model.train(was_training)
    return max(peaks)


def check_softmax_bound(model, src=None, bound: float = SAFE_SCORE_BOUND,
                        strict: bool = False) -> float:
    """Calibration-time guard for the TPU kernels' max-free softmax: the
    peak |score| on `src` (by default a standard-normal batch of 32 shaped
    for the arm, from numpy's seed 0, as vitiq's) against `bound`; warns
    (RuntimeWarning), or raises ValueError with `strict`, where it exceeds
    it. Returns the peak. A calibration bound, not a proof: inputs out of
    distribution can still exceed it."""
    cfg = model.cfg
    if src is None:
        rng = np.random.default_rng(0)
        shape = ((32, cfg.in_channels, cfg.img_size_h, cfg.img_size_w) if cfg.arm == "vit"
                 else (32, cfg.in_channels, cfg.seq_length))
        src = rng.standard_normal(shape).astype(np.float32)
    peak = max_abs_attention_score(model, src)
    if peak > bound:
        msg = (f"peak |attention score| {peak:.1f} exceeds the softmax safety bound "
               f"{bound:.0f}. The port's kernels subtract the row max, so they are safe; the "
               f"bound guards these weights' exports to the JAX package's TPU kernels "
               f"(their max-free fused softmax may overflow: serve there with "
               f"VITIQ_NO_FUSED_LAYER=1 or the 'reference' numerics) and f32 exp")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return peak
