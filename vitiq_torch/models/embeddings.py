"""Token embeddings and positional encoding (counterpart of
`vitiq/models/embeddings.py`).

The reference's strided Conv2d / Conv1d patchifiers are plain GEMMs once the
input is folded: a reshape/transpose into [B, N, C*p*p] with (C, kh, kw)
feature order, then one matmul against the conv weight flattened to
[d, C*p*p]. Conv modules are not used on purpose: under the f32 `reference`
policy cuDNN would run them in TF32 on the GPU. The parameters keep the
reference conv shapes ([d, C, p, p] and [d, C, k]), so reference checkpoints
load with a plain `load_state_dict`.

Sinusoidal PE: enc[p, 2i] = sin(p / 10000^(2i/d)), enc[p, 2i+1] = cos(...),
added without scaling, in the activation dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vitiq_torch.models.layers import _uniform_
from vitiq_torch.ops.numerics import REFERENCE, Policy


class ConvProjection(nn.Module):
    """A stride-equals-kernel convolution held as its weight [d, C, *k] and
    applied to folded windows as one GEMM."""

    def __init__(self, d_model: int, in_channels: int, kernel: tuple,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((d_model, in_channels) + tuple(kernel), device=device))
        self.bias = nn.Parameter(torch.empty(d_model, device=device))
        bound = 1.0 / math.sqrt(in_channels * math.prod(kernel))
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, folded: torch.Tensor, policy: Policy = REFERENCE) -> torch.Tensor:
        """folded [..., C*prod(k)] in (C, k...) order -> [..., d]."""
        w = self.weight.reshape(self.weight.shape[0], -1)
        return policy.cast_output(policy.dot(folded, w.t()) + self.bias)


def fold_patches_2d(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, C*p*p] with (C, ph, pw) feature order."""
    B, C, H, W = x.shape
    p = patch_size
    x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def fold_segments_1d(x: torch.Tensor, segment_size: int) -> torch.Tensor:
    """[B, C, L] -> [B, L/s, C*s] with (C, k) feature order."""
    B, C, L = x.shape
    s = segment_size
    x = x.reshape(B, C, L // s, s).permute(0, 2, 1, 3)
    return x.reshape(B, L // s, C * s)


class PatchEmbedding2d(nn.Module):
    """ViT arm: [B, C, H, W] -> [B, N, d]."""

    def __init__(self, in_channels: int, patch_size: int, d_model: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.projection = ConvProjection(d_model, in_channels,
                                         (patch_size, patch_size), device, generator)

    def forward(self, x: torch.Tensor, policy: Policy = REFERENCE) -> torch.Tensor:
        return self.projection(fold_patches_2d(x, self.patch_size), policy)


class SequenceEmbedding(nn.Module):
    """rawIQ arm: [B, C, L] -> [B, T, d]; 'conv1d' (T = L, kernel 1) or
    'segment' (T = L/s, kernel = stride = s)."""

    def __init__(self, in_channels: int, d_model: int, method: str,
                 segment_size: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if method == "conv1d":
            k = 1
        elif method == "segment":
            if segment_size is None:
                raise ValueError("segment_size is required for 'segment' method")
            k = segment_size
        else:
            raise ValueError(f"Unknown method: {method}. Use 'conv1d' or 'segment'")
        self.method = method
        self.segment_size = k
        self.projection = ConvProjection(d_model, in_channels, (k,), device, generator)

    def forward(self, x: torch.Tensor, policy: Policy = REFERENCE) -> torch.Tensor:
        if self.method == "conv1d":
            tokens = x.transpose(1, 2)  # pointwise conv == per-sample dense
        else:
            tokens = fold_segments_1d(x, self.segment_size)
        return self.projection(tokens, policy)


def sinusoidal_encoding(max_len: int, d_model: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """[max_len, d_model] table, computed in f32 as the reference does."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    two_i = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    denominator = torch.pow(torch.full((), 10000.0, device=device), two_i / d_model)
    angles = pos / denominator
    enc = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return enc.reshape(max_len, -1)[:, :d_model].to(dtype)


def add_positional_encoding(x: torch.Tensor, max_len: int) -> torch.Tensor:
    """x [B, L, D] + enc[:L], the table cast to x's dtype before the add."""
    B, L, D = x.shape
    if L > max_len:
        raise ValueError(f"sequence length {L} exceeds positional-encoding max_len {max_len}")
    return x + sinusoidal_encoding(max_len, D, x.dtype, x.device)[:L]
