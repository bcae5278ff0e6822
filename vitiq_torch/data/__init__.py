"""Data feeds for `fit` (the in-RAM part of `vitiq/data`)."""

from vitiq_torch.data.feeds import ArrayFeed, DataFeed, as_feed  # noqa: F401
