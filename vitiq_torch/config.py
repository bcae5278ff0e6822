"""Configuration: the reference's dataclasses, plus the flagship geometries.

`vitiq.config` imports only the standard library, so the port shares it
instead of copying it. The flagship constructors mirror `vitiq/bench.py`
(which imports JAX and so cannot be imported here).
"""

from __future__ import annotations

from vitiq.config import DataConfig, ExperimentConfig, ModelConfig

__all__ = ["DataConfig", "ExperimentConfig", "ModelConfig",
           "flagship_vit_config", "flagship_rawiq_config"]


def flagship_vit_config(numerics: str = "tpu") -> ModelConfig:
    """The reference's production ViT arm: d128/L6/H8, FFN 512, patch 4 over
    the [1, 32, 64] image (129 tokens with CLS), 19 classes."""
    return ModelConfig(arm="vit", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=512, drop_prob=0.1, patch_size=4,
                       numerics=numerics)


def flagship_rawiq_config(numerics: str = "tpu") -> ModelConfig:
    """The rawIQ flagship: d128/L6/H8, FFN 1024, segment-16 tokens (65 with
    CLS), CLS pooling, head LayerNorm eps 1e-5, 19 classes."""
    return ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                       n_layers=6, ffn_hidden=1024, drop_prob=0.2,
                       segment_size=16, numerics=numerics)
