"""PolyMNIST (MMNIST) with synthetic Missing-At-Random modalities
(counterpart of ``multivae_tpu/data/datasets/mmnist.py``).

Reads the five ``m{i}`` modality files and ``labels`` of
``<data_path>/MMNIST/<split>``: ``.npy`` where present, else the zenodo
archive's ``.pt`` tensors through ``torch.load(weights_only=True)``.
``missing_ratio`` and ``keep_incomplete`` give the JAX package's protocol:
modality i is kept with probability ``1 - missing_ratio`` from
``default_rng(i)``, ``m0`` is always kept, missing rows are zeroed, and
``keep_incomplete=False`` keeps the first ``ceil((1 - r) ** 4 * n)`` rows
instead.
"""

from __future__ import annotations

import math
import os
from typing import Literal

import numpy as np
import torch

from .base import MultimodalBaseDataset


def _load_array(path_pt: str) -> np.ndarray:
    path_npy = path_pt.replace(".pt", ".npy")
    if os.path.exists(path_npy):
        return np.load(path_npy)
    if os.path.exists(path_pt):
        return torch.load(path_pt, weights_only=True).numpy()
    raise FileNotFoundError(path_pt)


def _exists(path_pt: str) -> bool:
    return os.path.exists(path_pt) or os.path.exists(path_pt.replace(".pt", ".npy"))


class MMNISTDataset(MultimodalBaseDataset):
    """Five-modality PolyMNIST.

    Args:
        data_path: folder holding ``MMNIST/<split>/m{i}.pt`` (or ``.npy``).
        split: 'train' or 'test'.
        download: fetch the zenodo archive when the files are absent.
        missing_ratio: share of missing rows per modality (MAR).
        keep_incomplete: keep the incomplete rows with masks (True) or only
            the first ``ceil((1 - r) ** 4 * n)`` rows, complete (False).
    """

    def __init__(self, data_path: str, transform=None, target_transform=None,
                 split: Literal["train", "test"] = "train", download: bool = False,
                 missing_ratio: float = 0.0, keep_incomplete: bool = True):
        data_path = os.path.expanduser(str(data_path))
        paths = [os.path.join(data_path, "MMNIST", split, f"m{i}.pt") for i in range(5)]
        if not _exists(paths[0]):
            if download:
                from ..download import maybe_download_mmnist

                maybe_download_mmnist(data_path)
            if not _exists(paths[0]):
                raise AttributeError(
                    "The PolyMNIST dataset is not available at the given "
                    "datapath. Pass download=True or fetch "
                    "https://zenodo.org/record/4899160/files/PolyMNIST.zip "
                    "and extract it there.")
        self.missing_ratio = missing_ratio
        self.keep_incomplete = keep_incomplete

        images = {f"m{i}": np.asarray(_load_array(paths[i]), np.float32) for i in range(5)}
        labels = np.asarray(_load_array(
            os.path.join(data_path, "MMNIST", split, "labels.pt"))).astype(np.int64)
        self.num_files = len(labels)
        self._incomplete = missing_ratio > 0 and keep_incomplete

        if self._incomplete:
            masks = {f"m{i}": np.random.default_rng(i).binomial(
                1, 1 - missing_ratio, size=self.num_files).astype(bool) for i in range(5)}
            masks["m0"] = np.ones(self.num_files, bool)   # every row keeps one
            for k in masks:
                images[k] = images[k] * masks[k].reshape(
                    -1, *([1] * (images[k].ndim - 1))).astype(np.float32)
            self.masks = masks
        elif missing_ratio > 0:
            new_len = math.ceil((1 - missing_ratio) ** 4 * self.num_files)
            images = {k: v[:new_len] for k, v in images.items()}
            labels = labels[:new_len]
        super().__init__(images, labels)

    def get_batch(self, indices):
        out = super().get_batch(indices)
        if self._incomplete:
            out["masks"] = {m: v[indices] for m, v in self.masks.items()}
        return out
