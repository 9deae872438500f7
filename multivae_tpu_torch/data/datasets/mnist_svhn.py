"""Label-paired MNIST x SVHN (counterpart of
``multivae_tpu/data/datasets/mnist_svhn.py``).

The sources are read from their standard files: MNIST's idx files
(``train-images-idx3-ubyte`` ..., plain or ``.gz``) under
``<data_path>/MNIST/raw``, SVHN's ``<split>_32x32.mat`` under
``<data_path>`` (``scipy.io``; label 10 is digit 0). Each MNIST digit is
paired with SVHN digits of its class ``data_multiplication`` times. The
pairing is cached on disk under ``mnist_svhn_idx_data_mul_<k>/<split>``
and drawn from ``default_rng(seed)`` in the JAX package's order, so both
packages write the same index files and read the same pairs.
"""

from __future__ import annotations

import gzip
import logging
import os
from pathlib import Path
from typing import Union

import numpy as np

from .base import MultimodalBaseDataset

logger = logging.getLogger(__name__)


def _read_idx(path: str) -> np.ndarray:
    """A uint8 idx file (plain or gzipped) as an array of its dims."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def load_mnist(data_path: str, train: bool = True):
    """(images uint8 (N, 28, 28), labels int64 (N,)) from the raw idx files."""
    prefix = "train" if train else "t10k"
    raw_dir = os.path.join(data_path, "MNIST", "raw")
    for ext in ["", ".gz"]:
        img_path = os.path.join(raw_dir, f"{prefix}-images-idx3-ubyte{ext}")
        lab_path = os.path.join(raw_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(img_path) and os.path.exists(lab_path):
            return _read_idx(img_path), _read_idx(lab_path).astype(np.int64)
    raise FileNotFoundError(
        f"MNIST raw files not found under {raw_dir}. Place the standard "
        "idx files there (train-images-idx3-ubyte, ...).")


def load_svhn(data_path: str, split: str = "train"):
    """(images uint8 (N, 3, 32, 32), labels int64 (N,) in [0, 10)) from the
    .mat file."""
    from scipy import io as sio

    mat_path = os.path.join(data_path, f"{split}_32x32.mat")
    if not os.path.exists(mat_path):
        raise FileNotFoundError(
            f"SVHN file {mat_path} not found. Download {split}_32x32.mat "
            "from http://ufldl.stanford.edu/housenumbers/ first.")
    mat = sio.loadmat(mat_path)
    images = np.transpose(mat["X"], (3, 2, 0, 1))   # (32, 32, 3, N) -> (N, 3, 32, 32)
    labels = mat["y"].astype(np.int64).squeeze() % 10
    return images, labels


class MnistSvhn(MultimodalBaseDataset):
    """Paired MNIST-SVHN with on-disk pairing indices.

    Args:
        data_path: folder holding MNIST/raw and the SVHN .mat files.
        split: 'train' or 'test'.
        data_multiplication: pairings per digit.
        seed: seed of the pairing and of the rows' order.
    """

    def __init__(self, data_path: Union[str, Path], split: str = "train",
                 download: bool = False, data_multiplication: int = 5, seed: int = 0,
                 **kwargs):
        if split not in ["train", "test"]:
            raise AttributeError("Possible values for split are 'train' or 'test'")
        data_path = str(data_path)
        self.data_mul = data_multiplication
        self.path_to_idx = os.path.join(
            data_path, f"mnist_svhn_idx_data_mul_{self.data_mul}", split)

        mnist_images, mnist_labels = load_mnist(data_path, train=(split == "train"))
        svhn_images, svhn_labels = load_svhn(data_path, split)

        rng = np.random.default_rng(seed)
        if not self._check_pairing_exists():
            self.create_pairing(mnist_labels, svhn_labels, rng)
        i_mnist = np.load(os.path.join(self.path_to_idx, "mnist_idx.npy"))
        i_svhn = np.load(os.path.join(self.path_to_idx, "svhn_idx.npy"))

        order = rng.permutation(len(i_mnist))
        labels = mnist_labels[i_mnist][order]
        data = dict(
            mnist=(mnist_images[i_mnist[order]].astype(np.float32) / 255.0)[:, None],
            svhn=svhn_images[i_svhn[order]].astype(np.float32) / 255.0)
        self.data_path = data_path
        super().__init__(data, labels)

    def _check_pairing_exists(self) -> bool:
        for name in ["mnist_idx.npy", "svhn_idx.npy"]:
            if not os.path.exists(os.path.join(self.path_to_idx, name)):
                logger.warning("Pairing not found.")
                return False
        return True

    def rand_match_on_idx(self, l1, idx1, l2, idx2, rng, max_d: int = 10000):
        """For each label, ``data_mul`` random matchings of the first
        ``min(count1, count2, max_d)`` indices of each source."""
        _idx1, _idx2 = [], []
        for lab in np.unique(l1):
            l_idx1, l_idx2 = idx1[l1 == lab], idx2[l2 == lab]
            n = min(len(l_idx1), len(l_idx2), max_d)
            l_idx1, l_idx2 = l_idx1[:n], l_idx2[:n]
            for _ in range(self.data_mul):
                _idx1.append(l_idx1[rng.permutation(n)])
                _idx2.append(l_idx2[rng.permutation(n)])
        return np.concatenate(_idx1), np.concatenate(_idx2)

    def create_pairing(self, mnist_labels, svhn_labels, rng, max_d: int = 10000):
        """Pair the label-sorted sources and save ``mnist_idx.npy`` and
        ``svhn_idx.npy`` under ``path_to_idx``."""
        logger.info("Creating indices in %s", self.path_to_idx)
        mnist_li = np.argsort(mnist_labels, kind="stable")
        svhn_li = np.argsort(svhn_labels, kind="stable")
        idx1, idx2 = self.rand_match_on_idx(mnist_labels[mnist_li], mnist_li,
                                            svhn_labels[svhn_li], svhn_li, rng, max_d=max_d)
        Path(self.path_to_idx).mkdir(parents=True, exist_ok=True)
        np.save(os.path.join(self.path_to_idx, "mnist_idx.npy"), idx1)
        np.save(os.path.join(self.path_to_idx, "svhn_idx.npy"), idx2)
