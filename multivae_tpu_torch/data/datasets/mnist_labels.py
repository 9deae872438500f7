"""MNIST images with their one-hot class as a second modality (counterpart
of ``multivae_tpu/data/datasets/mnist_labels.py``): ``images`` (1, 28, 28)
in [0, 1] and ``labels`` (1, 10)."""

from __future__ import annotations

import numpy as np

from .base import MultimodalBaseDataset
from .mnist_svhn import load_mnist


class MnistLabels(MultimodalBaseDataset):
    """MNIST with labels as a second modality, read from the raw idx files
    under ``<data_path>/MNIST/raw``."""

    def __init__(self, data_path: str, split: str = "train", download: bool = False,
                 **kwargs):
        if split not in ["train", "test"]:
            raise AttributeError("Possible values for split are 'train' or 'test'")
        images, labels = load_mnist(data_path, train=(split == "train"))
        images = (images.astype(np.float32) / 255.0)[:, None]
        one_hot = np.eye(10, dtype=np.float32)[labels][:, None, :]
        super().__init__(data=dict(images=images, labels=one_hot), labels=labels)
