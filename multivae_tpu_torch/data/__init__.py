from .batch import MultimodalBatch, as_batch, batch_from_arrays
from .datasets import DatasetOutput, IncompleteDataset, MultimodalBaseDataset
from .loader import DataLoader

__all__ = [
    "DataLoader",
    "DatasetOutput",
    "IncompleteDataset",
    "MultimodalBaseDataset",
    "MultimodalBatch",
    "as_batch",
    "batch_from_arrays",
]
