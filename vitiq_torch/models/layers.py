"""Transformer layers (counterpart of `vitiq/models/layers.py`).

Reference numerics, as in `vitiq`:
  * LayerNorm: biased variance, eps=1e-12, affine gamma/beta, statistics in
    f32; the output dtype is the residual-stream dtype of the policy.
  * MultiHeadAttention: four Linear(d, d) projections with bias, one fused
    QKV GEMM, -10000 mask fill, no attention dropout.
  * PositionwiseFeedForward: Linear -> ReLU -> Dropout -> Linear.
  * EncoderLayer: post-norm, dropout before each residual add.

Parameters are stored in PyTorch layout (`Linear.weight` is [out, in]) under
the reference checkpoint's key names. Initialization follows
torch.nn.Linear's bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the
CPU from an optional `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.ops.numerics import REFERENCE, Policy

LN_EPS = 1e-12  # reference LayerNorm eps


def _uniform_(param: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    """Fill `param` from U(-bound, bound) drawn on the CPU, so one seeded CPU
    generator initializes a model identically on every device."""
    values = torch.empty(param.shape, dtype=torch.float32)
    values.uniform_(-bound, bound, generator=generator)
    with torch.no_grad():
        param.copy_(values)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; identity when not training. The keep mask is drawn
    from `generator` (on `x`'s device) when one is given."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, device=x.device, generator=generator)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = LN_EPS,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Biased-variance LayerNorm over the last dim with f32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = gamma * ((x32 - mean) / torch.sqrt(var + eps)) + beta
    return out if out_dtype is None else out.to(out_dtype)


class Linear(nn.Module):
    """y = x @ weight.T + bias under a numerics policy."""

    def __init__(self, fan_in: int, fan_out: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in, device=device))
        self.bias = nn.Parameter(torch.empty(fan_out, device=device))
        bound = 1.0 / math.sqrt(fan_in)
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor, policy: Policy = REFERENCE) -> torch.Tensor:
        return policy.cast_output(policy.dot(x, self.weight.t()) + self.bias)


class LayerNorm(nn.Module):
    """The encoder's LayerNorm: parameters named gamma/beta, eps 1e-12."""

    def __init__(self, d_model: int, eps: float = LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(d_model, device=device))
        self.beta = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta, self.eps, out_dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_head: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_head = n_head
        self.w_q = Linear(d_model, d_model, device, generator)
        self.w_k = Linear(d_model, d_model, device, generator)
        self.w_v = Linear(d_model, d_model, device, generator)
        self.w_concat = Linear(d_model, d_model, device, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                policy: Policy = REFERENCE) -> torch.Tensor:
        """Self-attention (q = k = v = x); one [D, 3D] QKV GEMM."""
        B, L, D = x.shape
        d_head = D // self.n_head
        w_qkv = torch.cat([self.w_q.weight, self.w_k.weight, self.w_v.weight]).t()
        b_qkv = torch.cat([self.w_q.bias, self.w_k.bias, self.w_v.bias])
        qkv = policy.cast_output(policy.dot(x, w_qkv) + b_qkv)
        q, k, v = qkv.split(D, dim=-1)

        def split(t):  # [B, L, D] -> [B, H, L, Dh]
            return t.reshape(B, L, self.n_head, d_head).transpose(1, 2)

        out = scaled_dot_product_attention(split(q), split(k), split(v),
                                           mask=mask, policy=policy)
        out = out.transpose(1, 2).reshape(B, L, D)
        return self.w_concat(out, policy)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear1 = Linear(d_model, hidden, device, generator)
        self.linear2 = Linear(hidden, d_model, device, generator)

    def forward(self, x: torch.Tensor, drop_prob: float, train: bool,
                policy: Policy = REFERENCE,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.linear1(x, policy))
        h = dropout(h, drop_prob, train, generator)
        return self.linear2(h, policy)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer. `kernel_operands` caches the weights in the
    fused kernel's layout (see `vitiq_torch.ops.cuda.fused_encoder_layer.
    layer_operands`), rebuilt whenever a parameter changes."""

    def __init__(self, d_model: int, ffn_hidden: int, n_head: int,
                 drop_prob: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob = drop_prob
        self.attention = MultiHeadAttention(d_model, n_head, device, generator)
        self.norm1 = LayerNorm(d_model, device=device)
        self.ffn = PositionwiseFeedForward(d_model, ffn_hidden, device, generator)
        self.norm2 = LayerNorm(d_model, device=device)
        self.kernel_operands = {}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                policy: Policy = REFERENCE,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        train = self.training
        # residual stream: f32 under the reference policy, the compute dtype
        # (bf16) under the TPU policy
        stream = None if policy.compute_dtype == torch.float32 else policy.compute_dtype
        attn = self.attention(x, mask=mask, policy=policy)
        x = self.norm1(dropout(attn, self.drop_prob, train, generator) + x,
                       out_dtype=stream)
        ffn = self.ffn(x, self.drop_prob, train, policy=policy, generator=generator)
        return self.norm2(dropout(ffn, self.drop_prob, train, generator) + x,
                          out_dtype=stream)
