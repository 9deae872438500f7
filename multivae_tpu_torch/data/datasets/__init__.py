from .base import (
    DatasetOutput,
    IncompleteDataset,
    MultimodalBaseDataset,
    ResampleDataset,
    random_split,
)
from .celeba import CelebAttr
from .cub import CUB, CUBSentences
from .mhd import MHD
from .mmnist import MMNISTDataset
from .mnist_labels import MnistLabels
from .mnist_svhn import MnistSvhn
from .translated_mmnist import TranslatedMMNIST

__all__ = [
    "CUB",
    "CUBSentences",
    "CelebAttr",
    "DatasetOutput",
    "IncompleteDataset",
    "MHD",
    "MMNISTDataset",
    "MnistLabels",
    "MnistSvhn",
    "MultimodalBaseDataset",
    "ResampleDataset",
    "TranslatedMMNIST",
    "random_split",
]
