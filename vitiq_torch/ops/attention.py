"""Scaled dot-product attention (counterpart of `vitiq/ops/attention.py`).

``score = q @ k^T / sqrt(d_head)``; an optional mask fills masked positions
with -10000 (not -inf, as the reference does); the row max is subtracted
before ``exp`` and the probabilities are f32; no attention dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vitiq_torch.ops.numerics import REFERENCE, Policy

MASK_FILL_VALUE = -10000.0


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    policy: Policy = REFERENCE,
    return_scores: bool = False,
):
    """Attention over [B, H, L, Dh] tensors; positions where ``mask == 0``
    are filled with -10000 before the softmax. With ``return_scores``, also
    the post-softmax probabilities [B, H, L, L] (f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = policy.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(mask == 0, MASK_FILL_VALUE)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = policy.einsum("bhqk,bhkd->bhqd", probs, v)
    return (out, probs) if return_scores else out
