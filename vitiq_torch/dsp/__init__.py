"""Device front-end: normalization and model shaping of raw I/Q frames."""

from vitiq_torch.dsp.frontend import (  # noqa: F401
    preprocess_batch_rawiq,
    preprocess_batch_vit,
)
