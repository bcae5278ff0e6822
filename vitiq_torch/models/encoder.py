"""Shared CLS-token transformer encoder (counterpart of
`vitiq/models/encoder.py`).

  tokens = embed(src)
  x = concat([cls, tokens]) if cls else tokens
  x = x + PE[:L]; x = dropout(x)
  for layer in layers: x = EncoderLayer(x, mask)

Dispatch, without a mask and under a bf16 policy (on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain PyTorch versions):
* training, given the step's dropout seed, with ``VITIQ_FUSED_TRAIN`` not
  ``0`` and shapes the kernels take (`fused_train_supported`): the fused
  training stack (`vitiq_torch.ops.cuda.fused_layer_train`, K3 forward and
  backward, dropout drawn from the seed inside the kernels);
* eval: the fused inference stack (`vitiq_torch.ops.cuda.fused_encoder_layer`,
  K1/K2). With ``cls_only_fused`` the last layer computes the CLS row only
  and the encoder returns [B, 1, D]. Opt-outs, as in `vitiq`:
  ``VITIQ_NO_FUSED_LAYER=1`` runs the plain layer loop, ``VITIQ_CLS_ONLY=0``
  computes the full last layer.
Everything else runs the plain layers, their dropout drawn from `generator`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from vitiq.config import ModelConfig
from vitiq_torch.models.embeddings import (
    PatchEmbedding2d,
    SequenceEmbedding,
    add_positional_encoding,
)
from vitiq_torch.models.layers import EncoderLayer, dropout
from vitiq_torch.ops.cuda.fused_encoder_layer import fused_encoder_layer_stack
from vitiq_torch.ops.cuda.fused_layer_train import fused_train_layer_stack, fused_train_supported
from vitiq_torch.ops.numerics import Policy


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.arm == "vit":
            self.patch_embedding = PatchEmbedding2d(
                cfg.in_channels, cfg.patch_size, cfg.d_model, device, generator)
        else:
            self.sequence_embedding = SequenceEmbedding(
                cfg.in_channels, cfg.d_model, cfg.embedding_type,
                cfg.segment_size, device, generator)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.d_model, cfg.ffn_hidden, cfg.n_head, cfg.drop_prob,
                         device, generator)
            for _ in range(cfg.n_layers))
        # the ViT arm always has a CLS token; the rawIQ arm's is optional
        if cfg.arm == "vit" or cfg.use_cls_token:
            cls = torch.randn((1, 1, cfg.d_model), generator=generator)
            self.cls_token = nn.Parameter(cls.to(device))
        else:
            self.cls_token = None

    def embed(self, src: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Tokens with the CLS row prepended and the PE added: [B, L, D]."""
        cfg = self.cfg
        expected_rank = 4 if cfg.arm == "vit" else 3
        if src.dim() != expected_rank:
            raise ValueError(
                f"{cfg.arm} arm expects rank-{expected_rank} input "
                f"({'[B, C, H, W]' if cfg.arm == 'vit' else '[B, C, L]'}), "
                f"got shape {tuple(src.shape)}")
        if cfg.arm == "vit":
            x = self.patch_embedding(src, policy)
        else:
            x = self.sequence_embedding(src, policy)
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[2])
            x = torch.cat([cls, x], dim=1)
        return add_positional_encoding(x, cfg.num_tokens)

    def forward(self, src: torch.Tensor, policy: Policy,
                mask: Optional[torch.Tensor] = None,
                cls_only_fused: bool = False,
                generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """The full token sequence [B, L, D], or [B, 1, D] when the fused path
        computes the CLS row only (``cls_only_fused``). `seed` is the training
        step's int32 dropout seed for the fused training stack."""
        cfg = self.cfg
        x = dropout(self.embed(src, policy), cfg.drop_prob, self.training, generator)
        if (self.training
                and seed is not None
                and mask is None
                and policy.compute_dtype == torch.bfloat16
                and os.environ.get("VITIQ_FUSED_TRAIN", "1") != "0"
                and fused_train_supported(x.shape[1], cfg.d_model, cfg.ffn_hidden, cfg.n_head)):
            return fused_train_layer_stack(policy.cast_compute(x), list(self.layers),
                                           cfg.n_head, cfg.drop_prob, seed)
        if (not self.training
                and mask is None
                and policy.compute_dtype == torch.bfloat16
                and os.environ.get("VITIQ_NO_FUSED_LAYER") != "1"):
            cls_only = (cls_only_fused
                        and os.environ.get("VITIQ_CLS_ONLY", "1") != "0")
            return fused_encoder_layer_stack(policy.cast_compute(x),
                                             list(self.layers), cfg.n_head,
                                             cls_only=cls_only)
        for layer in self.layers:
            x = layer(x, mask=mask, policy=policy, generator=generator)
        return x
