"""Data (counterpart of `vitiq/data`): the synthetic corpus, the reference
split and normalization statistics, the HDF5 source and packed shards, the
in-RAM and streaming feeds, and the prefetching host-to-device feed. h5py is
imported only where an HDF5 file is read; nothing here needs scikit-learn."""

from vitiq_torch.data.feeds import ArrayFeed, DataFeed, StreamFeed, as_feed  # noqa: F401
from vitiq_torch.data.hdf5 import (  # noqa: F401
    HDF5DataSource,
    PackedDataSource,
    pack_split_to_npy,
)
from vitiq_torch.data.pipeline import Prefetcher, device_prefetch  # noqa: F401
from vitiq_torch.data.splits import (  # noqa: F401
    SplitIndices,
    load_dataset_metadata,
    split_data,
    split_labels,
)
from vitiq_torch.data.stats import (  # noqa: F401
    compute_normalization_stats,
    stats_from_array,
    stats_from_hdf5,
)
from vitiq_torch.data.synthetic import (  # noqa: F401
    ChannelModel,
    SyntheticAMCDataset,
    channel_from_config,
)
