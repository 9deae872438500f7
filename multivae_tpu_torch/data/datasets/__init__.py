from .base import (
    DatasetOutput,
    IncompleteDataset,
    MultimodalBaseDataset,
    ResampleDataset,
    random_split,
)

__all__ = ["DatasetOutput", "IncompleteDataset", "MultimodalBaseDataset",
           "ResampleDataset", "random_split"]
