"""Transformer layers (counterpart of `vitiq/models/layers.py`).

Reference numerics, as in `vitiq`:
  * LayerNorm: biased variance, eps=1e-12, affine gamma/beta, statistics in
    f32; the output dtype is the residual-stream dtype of the policy.
  * MultiHeadAttention: four Linear(d, d) projections with bias, one fused
    QKV GEMM, -10000 mask fill, no attention dropout. Its `attention_fn`, as
    `mha_apply`'s: one with ``packed_layout`` (K5's `fused_attention`) takes
    [B, L, D] q, k, v and `n_head`, any other the split heads [B, H, L, dh].
  * PositionwiseFeedForward: Linear -> ReLU -> Dropout -> Linear.
  * EncoderLayer: post-norm, dropout before each residual add.

Tensor parallelism (`parallel/mesh.py`): a layer sharded over a model
group of n ranks holds H/n heads (its rows of w_q/w_k/w_v, its columns of
w_concat) and F/n FFN columns; given the group (`tp`), the attention and
the FFN each take their input through `copy_to_model` and end in one
all-reduce of the row-parallel product in f32 (`reduce_from_model`), the
bias added after it. The FFN hidden site's dropout numbers its lanes from
the shard's first column, so the n ranks drop what one process drops.

Parameters are stored in PyTorch layout (`Linear.weight` is [out, in]) under
the reference checkpoint's key names. Initialization follows
torch.nn.Linear's bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the
CPU from an optional `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.parallel.comm import copy_to_model, reduce_from_model
from vitiq_torch.ops.cuda.fused_layer_train import hash_dropout, site_salt
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
            seed: Optional[Union[int, torch.Tensor]] = None, salt: int = 0,
            lane0: int = 0) -> torch.Tensor:
    """Inverted dropout; identity when not training. In training a position
    is dropped iff the low 31 bits of the fused training kernels' hash of
    the step's `seed` (an int, or an int32 tensor on `x`'s device) + `salt`,
    over x's last two dims as (token, lane) and the rest as frames, fall
    below rate * 2^31, and a kept one is scaled by 1 / (1 - rate) in f32
    (`hash_dropout`: one kernel on the card, its plain version on the CPU).
    The mask is a function of the seed alone, so a rematerialized layer
    recomputes it and a captured CUDA graph draws each replay's; a column
    shard numbers its lanes from `lane0`. Like vitiq's `dropout` without an
    rng, training without a seed raises."""
    if not train or rate == 0.0:
        return x
    if seed is None:
        raise ValueError("dropout requires the step's seed when train=True and rate > 0")
    return hash_dropout(x, rate, seed, salt, lane0)


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

    def row_parallel(self, x: torch.Tensor, policy: Policy, group) -> torch.Tensor:
        """The layer over its input columns' shard: the partial products
        summed over the model group in f32, then the whole bias."""
        return policy.cast_output(reduce_from_model(policy.dot(x, self.weight.t()), group)
                                  + self.bias)


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
                policy: Policy = REFERENCE,
                attention_fn: Callable = scaled_dot_product_attention,
                tp=None) -> torch.Tensor:
        """Self-attention (q = k = v = x); one [D, 3D] QKV GEMM. Under
        tensor parallelism (`tp`, the model group) the rank's heads only,
        then one all-reduce."""
        B, L, D = x.shape
        d_head = D // self.n_head
        width = self.w_q.weight.shape[0]  # D, or the rank's heads' columns
        heads = width // d_head
        x = copy_to_model(x, tp)
        w_qkv = torch.cat([self.w_q.weight, self.w_k.weight, self.w_v.weight]).t()
        b_qkv = torch.cat([self.w_q.bias, self.w_k.bias, self.w_v.bias])
        qkv = policy.cast_output(policy.dot(x, w_qkv) + b_qkv)
        q, k, v = qkv.split(width, dim=-1)
        if getattr(attention_fn, "packed_layout", False):
            out = attention_fn(q, k, v, heads, mask=mask, policy=policy)
        else:
            def split(t):  # [B, L, width] -> [B, heads, L, Dh]
                return t.reshape(B, L, heads, d_head).transpose(1, 2)

            out = attention_fn(split(q), split(k), split(v), mask=mask, policy=policy)
            out = out.transpose(1, 2).reshape(B, L, width)
        if tp is not None:
            return self.w_concat.row_parallel(out, policy, tp)
        return self.w_concat(out, policy)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear1 = Linear(d_model, hidden, device, generator)
        self.linear2 = Linear(hidden, d_model, device, generator)

    def forward(self, x: torch.Tensor, drop_prob: float, train: bool,
                policy: Policy = REFERENCE,
                seed: Optional[Union[int, torch.Tensor]] = None,
                salt: int = 0, tp=None, tp_index: int = 0) -> torch.Tensor:
        """Under tensor parallelism (`tp`, the model group; `tp_index`, the
        rank's index in it) the rank's hidden columns, then one all-reduce."""
        h = torch.relu(self.linear1(copy_to_model(x, tp), policy))
        h = dropout(h, drop_prob, train, seed, salt, lane0=tp_index * h.shape[-1])
        if tp is not None:
            return self.linear2.row_parallel(h, policy, tp)
        return self.linear2(h, policy)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer. `kernel_operands` caches the weights in the
    fused kernel's layout (see `vitiq_torch.ops.cuda.fused_encoder_layer.
    layer_operands`), rebuilt whenever a parameter changes. In training its
    three dropout sites draw from the step's `seed` with the fused training
    kernels' salts of (`layer_idx`, site), so a plain layer drops what K3/K4
    drop at that layer."""

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
                attention_fn: Callable = scaled_dot_product_attention,
                seed: Optional[Union[int, torch.Tensor]] = None,
                layer_idx: int = 0, tp=None, tp_index: int = 0) -> torch.Tensor:
        train = self.training
        # residual stream: f32 under the reference policy, the compute dtype
        # (bf16) under the TPU policy
        stream = None if policy.compute_dtype == torch.float32 else policy.compute_dtype
        attn = self.attention(x, mask=mask, policy=policy, attention_fn=attention_fn, tp=tp)
        x = self.norm1(dropout(attn, self.drop_prob, train, seed, site_salt(layer_idx, 0)) + x,
                       out_dtype=stream)
        ffn = self.ffn(x, self.drop_prob, train, policy=policy, seed=seed,
                       salt=site_salt(layer_idx, 1), tp=tp, tp_index=tp_index)
        return self.norm2(dropout(ffn, self.drop_prob, train, seed, site_salt(layer_idx, 2)) + x,
                          out_dtype=stream)
