"""DSP front-end (counterpart of `vitiq/dsp`): RRC taps and the matched
filter, symbol timing recovery (the error-feedback loops one kernel launch on
the card: `ops/cuda/timing.py`), symbol extraction, normalization and the
batched device front-ends that feed the models; the polyphase channelizer is
`dsp/channelizer.py`."""

from vitiq_torch.dsp.taps import rrc_filter  # noqa: F401
from vitiq_torch.dsp.filtering import matched_filter  # noqa: F401
from vitiq_torch.dsp.timing import (  # noqa: F401
    simple_timing_recovery,
    timing_recovery_gardner,
    timing_recovery_mueller_muller,
)
from vitiq_torch.dsp.frontend import (  # noqa: F401
    apply_normalization,
    extract_symbols,
    preprocess_batch_amplitude_phase,
    preprocess_batch_mdf,
    preprocess_batch_rawiq,
    preprocess_batch_sps,
    preprocess_batch_spectrogram,
    preprocess_batch_vit,
    preprocess_batch_vit_spectrogram,
    preprocess_for_transformer,
    preprocess_for_vit,
)
