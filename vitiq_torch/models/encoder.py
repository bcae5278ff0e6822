"""Shared CLS-token transformer encoder (counterpart of
`vitiq/models/encoder.py`).

  tokens = embed(src)
  x = concat([cls, tokens]) if cls else tokens
  x = x + PE[:L]; x = dropout(x)
  for layer in layers: x = EncoderLayer(x, mask)

With ``raw_stats`` (the i/q mean and std), `src` is the raw [B, L, 2] frame
batch and the first three lines are one GEMM (`models/raw_embed.py`).

Dispatch, without a mask, under a bf16 policy and with a packed
`attention_fn` (K5's `fused_attention`, which `AMCModel` picks under `tpu`
numerics, as `make_forward` does) -- the fused families, on a CUDA tensor
the hand-written kernels, on a CPU tensor their plain PyTorch versions:
* training, given the step's dropout seed, with ``VITIQ_FUSED_TRAIN`` not
  ``0`` and shapes the kernels take (`fused_train_supported`): the fused
  training stack (`vitiq_torch.ops.cuda.fused_layer_train`: K4, the stash
  regime, where `stash_enabled` puts it, K3 elsewhere; dropout drawn from the
  seed inside the kernels);
* eval, with shapes the kernels take (`fused_infer_supported`): the fused
  inference stack (`vitiq_torch.ops.cuda.fused_encoder_layer`, K1/K2), or
  with ``VITIQ_ATTN_INT8=1`` its int8-attention twin
  (`vitiq_torch.ops.cuda.fused_encoder_layer_int8attn`, K7 on the full
  layers, K2 on the CLS row). With ``cls_only_fused`` the last layer computes
  the CLS row only and the encoder returns [B, 1, D]. Opt-outs, as in `vitiq`:
  ``VITIQ_NO_FUSED_LAYER=1`` runs the plain layer loop, ``VITIQ_CLS_ONLY=0``
  computes the full last layer.
Both gates are decided from shapes alone, so a shape a gate admits never
raises in a kernel and one it turns away never reaches one. Everything else
runs the plain layers with `attention_fn` (under `tpu`, K5 for every layer's
attention: in training the conv1d arm's 1025 tokens, which
`fused_train_supported` turns down; in eval the conv1d arm with n_head 2,
which `fused_infer_supported` turns down, and ``VITIQ_NO_FUSED_LAYER=1``).
In training above 512 tokens each plain layer is rematerialized (`use_remat`,
``VITIQ_TRAIN_REMAT``), as the JAX encoder does with `jax.checkpoint`.

Dropout outside the fused kernels (the embedding's, and the plain layers')
is the kernels' position hash of the step's `seed`, salted per site
(`EMBED_SALT`, and each layer's `site_salt(layer, site)`, the kernels' own),
through `hash_dropout` (one kernel on the card). `make_train_step` passes
the seed as an int32 tensor on the device, so a step's masks are a function
of a device value: an eager step and a replayed CUDA graph draw the same
bits, and remat recomputes them with no RNG state. A training forward
with dropout and no seed raises ValueError, as vitiq's does.

On a device mesh (`parallel/mesh.py`: `shard_model` records the mesh on
the model and its encoder, ``self.mesh``), as vitiq's encoder under an
ambient mesh:
* data axes above 1: the rank's linear data index is folded into the seed,
  ``seed + idx * -1640531527`` with int32 wrap-around, on the device when
  the seed is a device tensor; every dropout site hashes the folded seed,
  so the data ranks draw different masks and the model ranks of one data
  index the same ones. The fused families run on the rank's rows.
* a model axis above 1: the fused families stay off (they take whole
  weights), with a one-time warning, and the plain layers run the rank's
  heads and FFN columns with one all-reduce after attention and one after
  the FFN (`models/layers.py`); under `tpu` numerics K5 is their attention.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vitiq_torch.config import ModelConfig
from vitiq_torch.models.embeddings import (
    PatchEmbedding2d,
    SequenceEmbedding,
    add_positional_encoding,
)
from vitiq_torch.models.layers import EncoderLayer, dropout
from vitiq_torch.models.raw_embed import fused_raw_embed_apply
from vitiq_torch.ops.cuda.fused_encoder_layer import (
    fused_encoder_layer_stack,
    fused_infer_supported,
)
from vitiq_torch.ops.cuda.fused_encoder_layer_int8attn import fused_encoder_layer_int8attn_stack
from vitiq_torch.ops.cuda.fused_layer_train import (
    fused_train_layer_stack,
    fused_train_supported,
    site_salt,
)
from vitiq_torch.ops.numerics import Policy

# the embedding dropout's salt: layer -1's first site, apart from every layer's
EMBED_SALT = site_salt(-1, 0)
# the golden-ratio step that folds a data rank's index into the seed (vitiq's)
DATA_FOLD = -1640531527
_M32 = 0xFFFFFFFF


def fold_data_index(seed: Union[int, torch.Tensor], idx: int) -> Union[int, torch.Tensor]:
    """``seed + idx * DATA_FOLD`` in int32 with wrap-around: an int for an
    int seed, an int32 tensor on the seed's device (no host read) for a
    tensor one."""
    step = (idx * DATA_FOLD) & _M32
    if isinstance(seed, torch.Tensor):
        h = (seed.to(torch.int64) + step) & _M32
        return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
    h = (int(seed) + step) & _M32
    return h - (1 << 32) if h >= 1 << 31 else h


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
        self.mesh = None  # set by `parallel.mesh.shard_model`

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

    def forward(self, src: torch.Tensor, policy: Policy, attention_fn: Callable,
                mask: Optional[torch.Tensor] = None,
                cls_only_fused: bool = False,
                seed: Optional[Union[int, torch.Tensor]] = None,
                raw_stats: Optional[Dict[str, float]] = None) -> torch.Tensor:
        """The full token sequence [B, L, D], or [B, 1, D] when the fused path
        computes the CLS row only (``cls_only_fused``). `attention_fn` is the
        plain layers' attention (see `EncoderLayer`); only a packed one admits
        the fused families, so it has no default. `seed` is the training
        step's int32 dropout seed (an int, or an int32 tensor on the
        device), which every dropout site hashes. With `raw_stats`, `src` is
        the raw [B, L, 2] frame batch."""
        cfg = self.cfg
        if raw_stats is not None:
            x = fused_raw_embed_apply(self, src, cfg, raw_stats, policy)
        else:
            x = self.embed(src, policy)
        mesh = self.mesh
        tp = tp_index = None
        if mesh is not None and mesh.model_size > 1:
            tp, tp_index = mesh.model_group, mesh.model_index()
        if seed is not None and mesh is not None and mesh.data_size > 1:
            seed = fold_data_index(seed, mesh.data_index())
        x = dropout(x, cfg.drop_prob, self.training, seed, EMBED_SALT)
        fused_family = (policy.compute_dtype == torch.bfloat16
                        and getattr(attention_fn, "packed_layout", False))
        if tp is not None and fused_family:
            warnings.warn("the fused kernels are data-parallel only; a model axis above 1 "
                          "runs the plain layers (Megatron tensor parallelism)", stacklevel=2)
            fused_family = False
        if (self.training
                and seed is not None
                and mask is None
                and fused_family
                and os.environ.get("VITIQ_FUSED_TRAIN", "1") != "0"
                and fused_train_supported(x.shape[1], cfg.d_model, cfg.ffn_hidden, cfg.n_head)):
            return fused_train_layer_stack(policy.cast_compute(x), list(self.layers),
                                           cfg.n_head, cfg.drop_prob, seed)
        if (not self.training
                and mask is None
                and fused_family
                and os.environ.get("VITIQ_NO_FUSED_LAYER") != "1"
                and fused_infer_supported(x.shape[1], cfg.d_model, cfg.ffn_hidden, cfg.n_head)):
            cls_only = (cls_only_fused
                        and os.environ.get("VITIQ_CLS_ONLY", "1") != "0")
            stack = (fused_encoder_layer_int8attn_stack
                     if os.environ.get("VITIQ_ATTN_INT8") == "1" else fused_encoder_layer_stack)
            return stack(policy.cast_compute(x), list(self.layers), cfg.n_head,
                         cls_only=cls_only)
        kwargs = dict(mask=mask, policy=policy, attention_fn=attention_fn, seed=seed)
        if tp is not None:
            kwargs.update(tp=tp, tp_index=tp_index)
        remat = use_remat(self.training, x.shape[1])
        for i, layer in enumerate(self.layers):
            if remat:  # no RNG state to replay: the masks are the seed's
                x = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False,
                               layer_idx=i, **kwargs)
            else:
                x = layer(x, layer_idx=i, **kwargs)
        return x


def use_remat(train: bool, seq_len: int) -> bool:
    """``VITIQ_TRAIN_REMAT`` as the JAX encoder reads it: ``auto`` (default)
    rematerializes each plain layer in training above 512 tokens, ``1``
    always, ``0`` never."""
    env = os.environ.get("VITIQ_TRAIN_REMAT", "auto")
    return train and (env == "1" or (env == "auto" and seq_len > 512))
