"""Int8 post-training quantization for the serving path (counterpart of
`vitiq/ops/quant.py`).

W8A8 dynamic quantization, as the JAX package does it:
  * weights: per-output-channel symmetric int8 (absmax / 127), quantized once
    from a trained model (`quantize_linear_params`, `quantize_params_int8`);
  * activations: per-row symmetric int8 scales computed on the fly;
  * products accumulated exactly (int32 in the kernel, an f32 product of the
    integer operands in the plain version), dequantized by row scale times
    channel scale.
Only the GEMMs quantize; LayerNorm statistics, softmax, residuals and the
classifier head stay float.

`QuantizedAMCModel` is `make_quantized_forward`: preprocessed input (the
quantized path is not raw-aware), the embedding's `int8_linear` in plain
PyTorch, CLS and PE, then the encoder -- on a CUDA device (or with
``fused=True``), for shapes the kernels take (`fused_infer_supported`, K1's
predicate), the fused int8 stack, K6 on each full layer and K2 on the last
layer's dequantized weights for the CLS row (`ops/cuda/
fused_encoder_layer_int8.py`); otherwise, or with ``VITIQ_NO_FUSED_LAYER=1``,
the unfused int8 layers in f32 -- and the float head. Its buffers keep the
state-dict names of the float model's parameters, with ``weight`` of a
quantized linear replaced by ``weight_q`` and ``scale``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from vitiq_torch.config import ModelConfig
from vitiq_torch.models.amc import HEAD_LN_EPS
from vitiq_torch.models.embeddings import (
    add_positional_encoding,
    fold_patches_2d,
    fold_segments_1d,
)
from vitiq_torch.models.layers import layer_norm
from vitiq_torch.ops.attention import scaled_dot_product_attention
from vitiq_torch.ops.cuda.fused_encoder_layer import fused_infer_supported
from vitiq_torch.ops.cuda.fused_encoder_layer_int8 import (
    QMAX,
    absmax_scale,
    fused_encoder_layer_int8_stack,
    row_quant,
)
from vitiq_torch.ops.numerics import REFERENCE, TPU


def quantize_linear_params(weight: torch.Tensor, bias: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A weight in PyTorch layout, [out, in] (a convolution's [out, C, *k]
    is taken as [out, C * prod(k)]), and its bias -> ``weight_q`` int8
    [out, in], ``scale`` f32 [out] (absmax over the inputs / 127) and
    ``bias`` f32."""
    w = weight.detach().float().reshape(weight.shape[0], -1)
    scale = absmax_scale(w, 1)
    weight_q = torch.clamp(torch.round(w / scale), -QMAX, QMAX).to(torch.int8)
    return {"weight_q": weight_q, "scale": scale[:, 0], "bias": bias.detach().float().clone()}


def quantize_params_int8(
        state_dict: Mapping[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """Quantize every linear-shaped pair (``X.weight`` with two or more dims
    and ``X.bias``) of an `AMCModel` state dict to ``X.weight_q``,
    ``X.scale`` and ``X.bias``; everything else (LayerNorm affines, the CLS
    token) passes through as an f32 copy, and so does the classifier head
    (``mlp_head``, with the rawIQ head's LayerNorm), which stays float. The
    result loads into `QuantizedAMCModel`."""
    linears = {key[:-len(".weight")] for key, value in state_dict.items()
               if key.endswith(".weight") and value.dim() >= 2
               and key[:-len(".weight")] + ".bias" in state_dict
               and not key.startswith("mlp_head.")}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix not in linears:
            out[key] = value.detach().float().clone()
        elif leaf == "weight":
            for name, t in quantize_linear_params(value, state_dict[f"{prefix}.bias"]).items():
                out[f"{prefix}.{name}"] = t
    return out


def int8_linear(qlinear: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 matmul, f32 out: y = (x_q @ w_q^T) * (s_row
    s_col) + b, with per-row absmax scales of x (`row_quant`). The product
    of the integer operands is taken in f32, where it is exact (K <= 1040)."""
    x_q, row_scale = row_quant(x)
    acc = torch.matmul(x_q, qlinear["weight_q"].float().t())
    return acc * row_scale * qlinear["scale"] + qlinear["bias"]


class QuantizedLinear(nn.Module):
    """Buffers ``weight_q`` int8 [out, in], ``scale`` and ``bias`` f32 [out]."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros((fan_out, fan_in), dtype=torch.int8,
                                                     device=device))
        self.register_buffer("scale", torch.ones(fan_out, device=device))
        self.register_buffer("bias", torch.zeros(fan_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear({"weight_q": self.weight_q, "scale": self.scale, "bias": self.bias}, x)


class _Buffers(nn.Module):
    """Float tensors held as buffers under given names."""

    def __init__(self, device=None, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape, device=device))


class _Holder(nn.Module):
    """A named level of the module tree (keeps the float model's keys)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class QuantizedEncoderLayer(nn.Module):
    """The encoder layer with int8 projections and FFN (the state-dict keys
    of `EncoderLayer`). `forward` is the unfused int8 layer in f32, as
    `make_quantized_forward` runs it off the TPU; `kernel_operands` caches
    the fused stack's operands."""

    def __init__(self, d_model: int, ffn_hidden: int, device=None):
        super().__init__()
        lin = lambda i, o: QuantizedLinear(i, o, device)  # noqa: E731
        self.attention = _Holder(w_q=lin(d_model, d_model), w_k=lin(d_model, d_model),
                                 w_v=lin(d_model, d_model), w_concat=lin(d_model, d_model))
        self.norm1 = _Buffers(device, gamma=d_model, beta=d_model)
        self.ffn = _Holder(linear1=lin(d_model, ffn_hidden), linear2=lin(ffn_hidden, d_model))
        self.norm2 = _Buffers(device, gamma=d_model, beta=d_model)
        self.kernel_operands = {}

    def forward(self, x: torch.Tensor, n_head: int) -> torch.Tensor:
        B, L, D = x.shape
        att = self.attention

        def split(t):  # [B, L, D] -> [B, H, L, dh]
            return t.reshape(B, L, n_head, D // n_head).transpose(1, 2)

        out = scaled_dot_product_attention(split(att.w_q(x)), split(att.w_k(x)),
                                           split(att.w_v(x)), policy=TPU)
        attn = att.w_concat(out.transpose(1, 2).reshape(B, L, D))
        x = layer_norm(attn + x, self.norm1.gamma, self.norm1.beta)
        h = torch.relu(self.ffn.linear1(x))
        return layer_norm(self.ffn.linear2(h) + x, self.norm2.gamma, self.norm2.beta)


class QuantizedAMCModel(nn.Module):
    """The int8 W8A8 twin of `AMCModel` (`make_quantized_forward`): src
    [B, 1, H, W] (vit) or [B, C, L] (rawiq), preprocessed -> logits
    [B, num_classes] f32. ``fused`` picks the encoder: None (default) the
    fused int8 stack on a CUDA device and the unfused layers elsewhere;
    True or False forces it (True on the CPU runs the kernels' plain
    versions), the fused stack only for shapes `fused_infer_supported`
    admits. ``VITIQ_NO_FUSED_LAYER=1`` and ``VITIQ_CLS_ONLY=0`` act as in
    `vitiq`."""

    def __init__(self, cfg: ModelConfig, device=None, fused: Optional[bool] = None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.fused = fused
        d = cfg.d_model
        if cfg.arm == "vit":
            k = cfg.in_channels * cfg.patch_size ** 2
            embedding = {"patch_embedding": _Holder(projection=QuantizedLinear(k, d, device))}
        else:
            k = cfg.in_channels * (1 if cfg.embedding_type == "conv1d" else cfg.segment_size)
            embedding = {"sequence_embedding": _Holder(projection=QuantizedLinear(k, d, device))}
        self.encoder = _Holder(
            **embedding,
            layers=nn.ModuleList(QuantizedEncoderLayer(d, cfg.ffn_hidden, device)
                                 for _ in range(cfg.n_layers)))
        self.cls_pooling = cfg.arm == "vit" or cfg.use_cls_token
        if self.cls_pooling:
            self.encoder.register_buffer("cls_token", torch.zeros((1, 1, d), device=device))
        head = _Buffers(device, weight=(cfg.num_classes, d), bias=cfg.num_classes)
        self.mlp_head = (head if cfg.arm == "vit" else
                         nn.Sequential(_Buffers(device, weight=d, bias=d), head))

    @classmethod
    def from_model(cls, model, fused: Optional[bool] = None) -> "QuantizedAMCModel":
        """Quantize a trained `AMCModel` (`quantize_params_int8` of its state
        dict) onto its device."""
        device = next(model.parameters()).device
        qmodel = cls(model.cfg, device=device, fused=fused)
        qmodel.load_state_dict(quantize_params_int8(model.state_dict()))
        return qmodel.eval()

    def _embedding(self) -> QuantizedLinear:
        holder = (self.encoder.patch_embedding if self.cfg.arm == "vit"
                  else self.encoder.sequence_embedding)
        return holder.projection

    @torch.no_grad()
    def forward(self, src: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.arm == "vit":
            tokens = fold_patches_2d(src, cfg.patch_size)
        elif cfg.embedding_type == "conv1d":
            tokens = src.transpose(1, 2)
        else:
            tokens = fold_segments_1d(src, cfg.segment_size)
        x = self._embedding()(tokens)
        if self.cls_pooling:
            cls = self.encoder.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[2])
            x = torch.cat([cls, x], dim=1)
        x = add_positional_encoding(x, cfg.num_tokens)
        fused = self.fused if self.fused is not None else x.device.type == "cuda"
        layers = list(self.encoder.layers)
        if (fused and os.environ.get("VITIQ_NO_FUSED_LAYER") != "1"
                and fused_infer_supported(x.shape[1], cfg.d_model, cfg.ffn_hidden, cfg.n_head)):
            cls_only = self.cls_pooling and os.environ.get("VITIQ_CLS_ONLY", "1") != "0"
            x = fused_encoder_layer_int8_stack(x.to(torch.bfloat16), layers, cfg.n_head,
                                               cls_only=cls_only)
        else:
            for layer in layers:
                x = layer(x, cfg.n_head)
        feat = x[:, 0] if self.cls_pooling else x.mean(dim=1)
        if cfg.arm == "vit":
            head = self.mlp_head
        else:
            norm, head = self.mlp_head
            feat = layer_norm(feat, norm.weight, norm.bias, HEAD_LN_EPS)
        return (REFERENCE.dot(feat, head.weight.t()) + head.bias).float()
