"""AMC classifier heads over the shared encoder (counterpart of
`vitiq/models/amc.py`).

* ViT arm: token 0 (CLS) -> Linear(d, num_classes); no pre-head LayerNorm.
* rawIQ arm: CLS token or the mean over tokens -> LayerNorm(d, eps=1e-5,
  parameters named weight/bias as torch's nn.LayerNorm) -> Linear. The
  head is registered as ``mlp_head.0`` / ``mlp_head.1``, the reference's
  ``nn.Sequential`` keys.

Logits are rounded to the compute dtype by the head's ``cast_output`` and
returned as f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitiq.config import ModelConfig
from vitiq_torch.models.encoder import Encoder
from vitiq_torch.models.layers import Linear, layer_norm
from vitiq_torch.ops.numerics import policy_for

HEAD_LN_EPS = 1e-5  # the rawIQ head is a torch nn.LayerNorm (default eps)


class HeadLayerNorm(nn.Module):
    """The rawIQ head's LayerNorm: f32 statistics, f32 output."""

    def __init__(self, d_model: int, eps: float = HEAD_LN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d_model, device=device))
        self.bias = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class AMCModel(nn.Module):
    """src [B, 1, H, W] (vit) or [B, C, L] (rawiq) -> logits [B, num_classes] f32."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.policy = policy_for(cfg.numerics)
        self.encoder = Encoder(cfg, device, generator)
        head = Linear(cfg.d_model, cfg.num_classes, device, generator)
        if cfg.arm == "vit":
            self.mlp_head = head
        else:
            self.mlp_head = nn.Sequential(HeadLayerNorm(cfg.d_model, device=device), head)
        # CLS pooling consumes only token 0, so the fused serving path may
        # compute the last layer for the CLS row alone
        self.cls_pooling = cfg.arm == "vit" or cfg.use_cls_token

    def forward(self, src: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """In training, `generator` draws the dropout of the plain paths and
        `seed` (the step's int32 seed) that of the fused training kernels."""
        x = self.encoder(src, self.policy, cls_only_fused=self.cls_pooling,
                         generator=generator, seed=seed)
        feat = x[:, 0] if self.cls_pooling else x.mean(dim=1)
        if self.cfg.arm == "vit":
            logits = self.mlp_head(feat, self.policy)
        else:
            logits = self.mlp_head[1](self.mlp_head[0](feat), self.policy)
        return logits.float()
