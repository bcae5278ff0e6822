"""AMC classifier heads over the shared encoder (counterpart of
`vitiq/models/amc.py`).

* ViT arm: token 0 (CLS) -> Linear(d, num_classes); no pre-head LayerNorm.
* rawIQ arm: CLS token or the mean over tokens -> LayerNorm(d, eps=1e-5,
  parameters named weight/bias as torch's nn.LayerNorm) -> Linear. The
  head is registered as ``mlp_head.0`` / ``mlp_head.1``, the reference's
  ``nn.Sequential`` keys.

The plain layers' attention is K5 (`fused_attention`) under `tpu` numerics
and the split-head `scaled_dot_product_attention` under `reference`, as
`make_forward` picks it; only a packed one admits the fused layer stacks.

Logits are rounded to the compute dtype by the head's ``cast_output`` and
returned as f32.

With ``raw_stats`` (the i/q mean and std dict, counterpart of
`make_forward(cfg, raw_stats=...)`), the model takes raw [B, L, 2] frames and
the encoder runs preprocess + embedding + CLS + PE as one GEMM
(`models/raw_embed.py`). The stats are a plain attribute, not parameters or
buffers: the state_dict keys do not change.

Helpers on a model (counterparts of `vitiq/models/amc.py`'s functions of a
config and a parameter tree): `make_feature_extractor` (the encoder's
sequence and CLS outputs), `count_parameters` and `make_attention_map_fn`
(each layer's post-softmax attention maps).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from vitiq_torch.config import ModelConfig
from vitiq_torch.models.encoder import Encoder
from vitiq_torch.models.layers import Linear, layer_norm
from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.ops.cuda.flash_attention import fused_attention
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
    """src [B, 1, H, W] (vit) or [B, C, L] (rawiq), or raw [B, L, 2] frames
    when `raw_stats` is set -> logits [B, num_classes] f32."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 raw_stats: Optional[Dict[str, float]] = None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.raw_stats = raw_stats
        self.policy = policy_for(cfg.numerics)
        # as `make_forward`: K5 under the bf16 `tpu` numerics, the plain
        # split-head attention under `reference`
        self.attention_fn = (fused_attention if cfg.numerics == "tpu"
                             else scaled_dot_product_attention)
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
                seed: Optional[Union[int, torch.Tensor]] = None) -> torch.Tensor:
        """In training, `seed` (the step's int32 seed: an int, or an int32
        tensor on the device) draws every dropout mask (see `Encoder`)."""
        x = self.encoder(src, self.policy, cls_only_fused=self.cls_pooling,
                         seed=seed, raw_stats=self.raw_stats,
                         attention_fn=self.attention_fn)
        feat = x[:, 0] if self.cls_pooling else x.mean(dim=1)
        if self.cfg.arm == "vit":
            logits = self.mlp_head(feat, self.policy)
        else:
            logits = self.mlp_head[1](self.mlp_head[0](feat), self.policy)
        return logits.float()


def make_feature_extractor(model: AMCModel, attention_fn: Optional[Callable] = None):
    """Encoder-output access, parity with the rawIQ encoder's
    `get_cls_token_output` / `get_sequence_output` (counterpart of vitiq's
    `make_feature_extractor`). Returns fn(src) -> {"sequence_output":
    [B, L, d] (the CLS row dropped), "cls_output": [B, d] or None}, the
    encoder run in eval mode with `attention_fn` (default: the split-head
    `scaled_dot_product_attention`, as vitiq's, so the plain layers run)."""
    attention_fn = attention_fn or scaled_dot_product_attention

    @torch.no_grad()
    def extract(src: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        was_training = model.training
        model.eval()
        try:
            x = model.encoder(src, model.policy, attention_fn=attention_fn,
                              raw_stats=model.raw_stats)
        finally:
            model.train(was_training)
        return {"sequence_output": x[:, 1:] if model.cls_pooling else x,
                "cls_output": x[:, 0] if model.cls_pooling else None}

    return extract


def count_parameters(model: nn.Module) -> int:
    """Total trainable parameter count (counterpart of vitiq's
    `count_parameters` of a parameter tree)."""
    return sum(p.numel() for p in model.parameters())


def make_attention_map_fn(model: AMCModel):
    """Per-layer post-softmax attention maps (counterpart of vitiq's
    `make_attention_map_fn`). Returns fn(src) -> a list of n_layers f32
    tensors [B, H, L, L], from the plain layers in eval mode under the
    model's numerics policy."""

    @torch.no_grad()
    def extract(src: torch.Tensor) -> List[torch.Tensor]:
        maps: List[torch.Tensor] = []

        def capturing_attention(q, k, v, mask=None, policy=model.policy):
            out, probs = scaled_dot_product_attention(q, k, v, mask=mask, policy=policy,
                                                      return_scores=True)
            maps.append(probs)
            return out

        was_training = model.training
        model.eval()
        try:
            model.encoder(src, model.policy, attention_fn=capturing_attention,
                          raw_stats=model.raw_stats)
        finally:
            model.train(was_training)
        return maps

    return extract
