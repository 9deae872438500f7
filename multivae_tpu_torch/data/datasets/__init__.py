from .base import DatasetOutput, IncompleteDataset, MultimodalBaseDataset

__all__ = ["DatasetOutput", "IncompleteDataset", "MultimodalBaseDataset"]
