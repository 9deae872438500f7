from .batch import MultimodalBatch, as_batch, batch_from_arrays
from .datasets import (
    DatasetOutput,
    IncompleteDataset,
    MultimodalBaseDataset,
    ResampleDataset,
    random_split,
)
from .device_cache import (
    DeviceCachedLoader,
    DeviceDataCache,
    build_device_cache,
    release_sampler_cache,
)
from .loader import DataLoader
from .prefetch import PrefetchLoader

__all__ = [
    "DataLoader",
    "DatasetOutput",
    "DeviceCachedLoader",
    "DeviceDataCache",
    "IncompleteDataset",
    "MultimodalBaseDataset",
    "MultimodalBatch",
    "PrefetchLoader",
    "ResampleDataset",
    "as_batch",
    "batch_from_arrays",
    "build_device_cache",
    "random_split",
    "release_sampler_cache",
]
