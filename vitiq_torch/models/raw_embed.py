"""Fused raw-frame embedding: z-score + fold + embedding GEMM + CLS + PE as one
GEMM straight off the raw [B, L, 2] frames (counterpart of
`vitiq/models/raw_embed.py`).

Every step of the unfused front-end is affine in the raw frame, so

  tokens = zscore_fold(x) @ W + b + PE  ==  x_flat @ W' + b'

with W' a static re-indexing of W scaled by 1/sigma and b' carrying the
z-score shift (mu/sigma contracted through W) and, for the ViT arm, the CLS
row and the PE table. The operands are rebuilt on every call from the live
`projection` weight and bias and `cls_token`, so gradients reach them
through the GEMM. The product is a plain large GEMM (the JAX package leaves
it to XLA), so it goes through `Policy.dot`: bf16 operands under `tpu`
numerics, f32 accumulation. Under bf16 this rounds W/sigma once where the
unfused chain rounds z per element.

Arms:
  * vit     -- patches are a strided permutation of the frame: W expands to
               a block-sparse [2L, (N+1)*D] operand, CLS and PE ride in the
               bias.
  * segment -- each token is a contiguous run of 2*s raw values: W's rows
               are permuted (C, k) -> (k, C) and scaled by 1/sigma.
  * conv1d  -- the raw layout is already the fold: W is scaled by 1/sigma.
The segment and conv1d arms then prepend CLS (when configured) and add the
PE in the activation dtype.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from vitiq_torch.config import ModelConfig
from vitiq_torch.models.embeddings import sinusoidal_encoding
from vitiq_torch.ops.numerics import Policy


def fused_raw_embed_supported(cfg: ModelConfig) -> bool:
    """True when the arm's front-end is expressible as the fused GEMM."""
    if cfg.arm == "vit":
        # the image must be exactly the channel-major concat of the frame
        return (cfg.in_channels == 1
                and cfg.img_size_h * cfg.img_size_w == 2 * cfg.seq_length)
    if cfg.embedding_type == "segment":
        return cfg.segment_size is not None and cfg.seq_length % cfg.segment_size == 0
    return cfg.embedding_type == "conv1d"


def fused_raw_embed_enabled(cfg: ModelConfig) -> bool:
    """``VITIQ_FUSED_EMBED``: ``0`` off, ``1`` on wherever supported, ``auto``
    (default) on under the bf16 `tpu` numerics for the rawIQ arms, and for a
    ViT whose block-sparse operand is narrow ((N+1)*D <= 2048)."""
    env = os.environ.get("VITIQ_FUSED_EMBED", "auto")
    if env == "0" or not fused_raw_embed_supported(cfg):
        return False
    if env == "1":
        return True
    if cfg.numerics != "tpu":
        return False
    return cfg.arm != "vit" or cfg.num_tokens * cfg.d_model <= 2048


def _vit_maps(cfg: ModelConfig):
    """Static (p_of, t_of, c_of) over the interleaved flat index f = 2*l + c:
    the element's position in its patch, its patch, its channel."""
    L, W_img, ps = cfg.seq_length, cfg.img_size_w, cfg.patch_size
    m = np.arange(2 * L)  # channel-major flat position (I block then Q block)
    r, col = m // W_img, m % W_img
    t_of_m = (r // ps) * (W_img // ps) + col // ps
    p_of_m = (r % ps) * ps + (col % ps)
    c_of_m, l_of_m = m // L, m % L
    f_of_m = 2 * l_of_m + c_of_m
    p_of = np.empty(2 * L, np.int64)
    t_of = np.empty(2 * L, np.int64)
    c_of = np.empty(2 * L, np.int64)
    p_of[f_of_m], t_of[f_of_m], c_of[f_of_m] = p_of_m, t_of_m, c_of_m
    return p_of, t_of, c_of


def fused_raw_embed_apply(encoder, x: torch.Tensor, cfg: ModelConfig,
                          stats: Dict[str, float], policy: Policy) -> torch.Tensor:
    """[B, L, 2] raw frames -> [B, Ltok, D] tokens (CLS prepended where the
    arm has one, PE added): the preprocess -> embed -> CLS -> PE chain of
    `encoder` (an `Encoder`) as one GEMM."""
    B, L, C = x.shape
    if C != 2 or L != cfg.seq_length:
        raise ValueError(f"expected raw [B, {cfg.seq_length}, 2], got {tuple(x.shape)}")
    D = cfg.d_model
    dev = x.device
    embedding = encoder.patch_embedding if cfg.arm == "vit" else encoder.sequence_embedding
    proj = embedding.projection
    W = proj.weight.reshape(D, -1).t()  # the JAX kernel [(C*k...), D]
    b = proj.bias.float()
    mu = torch.tensor([stats["i_mean"], stats["q_mean"]], dtype=torch.float32, device=dev)
    inv_sigma = 1.0 / torch.tensor([stats["i_std"], stats["q_std"]], dtype=torch.float32,
                                   device=dev)

    if cfg.arm == "vit":
        p_of, t_of, c_of = (torch.from_numpy(a).to(dev) for a in _vit_maps(cfg))
        N = (cfg.img_size_h // cfg.patch_size) * (cfg.img_size_w // cfg.patch_size)
        wp = W[p_of] * inv_sigma[c_of][:, None]                        # [2L, D]
        onehot = torch.eye(N + 1, dtype=torch.float32, device=dev)[t_of + 1]
        w_big = (onehot[:, :, None] * wp[:, None, :]).reshape(2 * L, (N + 1) * D)
        shift = mu[c_of] @ w_big  # w_big rows already carry 1/sigma
        pe = sinusoidal_encoding(cfg.num_tokens, D, torch.float32, dev)[:N + 1]
        bias = torch.cat([encoder.cls_token.reshape(1, D).float(), b.expand(N, D)]) + pe
        out = policy.dot(x.reshape(B, 2 * L), w_big) + (bias.reshape(-1) - shift)
        return policy.cast_output(out).reshape(B, N + 1, D)

    if cfg.embedding_type == "segment":
        s = cfg.segment_size
        N = L // s
        # rows of the folded token are (C, k)-ordered; raw rows are (k, C)
        k = torch.arange(2 * s, device=dev) // 2
        c = torch.arange(2 * s, device=dev) % 2
        w_perm = W[c * s + k] * inv_sigma[c][:, None]                  # [2s, D]
        shift = mu[c] @ w_perm
        tokens = policy.cast_output(policy.dot(x.reshape(B, N, 2 * s), w_perm) + (b - shift))
    else:  # conv1d: per-sample pointwise embedding
        w_perm = W * inv_sigma[:, None]                                # [2, D]
        shift = mu @ w_perm
        tokens = policy.cast_output(policy.dot(x, w_perm) + (b - shift))
        N = L

    if encoder.cls_token is not None:
        cls = encoder.cls_token.to(tokens.dtype).expand(B, 1, D)
        tokens = torch.cat([cls, tokens], dim=1)
        N += 1
    return tokens + sinusoidal_encoding(cfg.num_tokens, D, tokens.dtype, dev)[:N]
