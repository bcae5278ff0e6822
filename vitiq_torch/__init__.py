"""vitiq_torch — the PyTorch / CUDA port of vitiq for NVIDIA Hopper GPUs.

`vitiq/` (JAX, Pallas kernels for the TPU) is the reference implementation;
this package computes the same functions with PyTorch and hand-written CUDA
kernels, and its tests hold it against `vitiq` on shared weights and inputs.
The layout mirrors `vitiq/`: the counterpart of `vitiq/models/encoder.py` is
`vitiq_torch/models/encoder.py`, and so on. Module `state_dict` keys are the
reference PyTorch checkpoint's own (`vitiq/interop.py`), so reference `.pth`
files load with a plain `load_state_dict`.

Run-time imports stay free of JAX: the only part of `vitiq` imported here is
`vitiq.config`, which needs the standard library alone.

Ported so far (the bf16 serving slice): numerics policies, attention, the
encoder layers, embeddings, encoder, classifier heads, the ViT / rawIQ
front-ends, checkpoint interop, the bucketed server, and the CUDA port of the
fused encoder-layer kernels (`csrc/fused_encoder_layer.cu`).
"""

from vitiq_torch.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    flagship_rawiq_config,
    flagship_vit_config,
)

__version__ = "0.1.0"
