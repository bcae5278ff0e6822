"""Data: the in-RAM feed for `fit`, the synthetic corpus and the
normalization statistics (the numpy part of `vitiq/data`; the HDF5 source,
the streaming feeds and the prefetcher are not ported yet)."""

from vitiq_torch.data.feeds import ArrayFeed, DataFeed, as_feed  # noqa: F401
from vitiq_torch.data.stats import compute_normalization_stats, stats_from_array  # noqa: F401
from vitiq_torch.data.synthetic import (  # noqa: F401
    ChannelModel,
    SyntheticAMCDataset,
    channel_from_config,
)
