from .batch import MultimodalBatch, as_batch, batch_from_arrays
from .datasets import (
    DatasetOutput,
    IncompleteDataset,
    MultimodalBaseDataset,
    ResampleDataset,
    random_split,
)
from .loader import DataLoader

__all__ = [
    "DataLoader",
    "DatasetOutput",
    "IncompleteDataset",
    "MultimodalBaseDataset",
    "MultimodalBatch",
    "ResampleDataset",
    "as_batch",
    "batch_from_arrays",
    "random_split",
]
