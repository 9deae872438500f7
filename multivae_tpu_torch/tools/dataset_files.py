"""Write the datasets' files, in their real formats and shapes, with random
content made from a seed, so that the dataset classes can be driven from
disk where the real archives are absent (the tests, ``chip_smoke.py``'s
``datasets`` phase):

- ``write_polymnist``: ``MMNIST/<split>/m{i}.npy`` (n, 3, 28, 28) float32
  in [0, 1) and ``labels.npy`` (int64); those named in ``pt`` as ``.pt``
  tensors instead, as the zenodo archive holds them;
- ``write_mnist``: MNIST's idx files under ``MNIST/raw`` (gzipped or not);
- ``write_svhn``: SVHN's ``<split>_32x32.mat`` (X (32, 32, 3, n) uint8, y in
  1..10, 10 for the digit 0);
- ``write_cub``: the mmdgm ``cub`` folder: 10 captions an image in
  ``text_trainvalclasses.txt`` / ``text_testclasses.txt`` and (H, W) RGB
  PNGs in class folders under ``cub/<split>``. Caption words are drawn
  from ``CUB_WORDS`` bird-description words and ``n_words`` made-up ones;
- ``write_translated_polymnist``: a generated Translated PolyMNIST tree,
  ``m{i}/{idx}.{digit}.png`` (28x28 RGB).

Images go through ``data/utils.write_png``: no image package is needed.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

from ..data.utils import write_png

CUB_WORDS = ("this bird has a small red beak and black wings with white bars on "
             "its long tail the yellow belly is brown grey crown breast feathers "
             "short pointed orange throat blue head medium sized body").split()


def write_polymnist(root: str, split: str, n: int, seed: int = 0, pt=()) -> str:
    """PolyMNIST's five modalities and labels for ``split``; returns root."""
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "MMNIST", split)
    os.makedirs(folder, exist_ok=True)
    for i in range(5):
        images = rng.random((n, 3, 28, 28), dtype=np.float32)
        if f"m{i}" in pt:
            torch.save(torch.from_numpy(images), os.path.join(folder, f"m{i}.pt"))
        else:
            np.save(os.path.join(folder, f"m{i}.npy"), images)
    labels = rng.integers(0, 10, n).astype(np.int64)
    if "labels" in pt:
        torch.save(torch.from_numpy(labels), os.path.join(folder, "labels.pt"))
    else:
        np.save(os.path.join(folder, "labels.npy"), labels)
    return root


def _idx(path: str, array: np.ndarray, gz: bool):
    header = struct.pack(">HBB", 0, 8, array.ndim) + struct.pack(
        f">{array.ndim}I", *array.shape)
    with (gzip.open if gz else open)(path + (".gz" if gz else ""), "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def write_mnist(root: str, n_train: int, n_test: int, seed: int = 0, gz: bool = True) -> str:
    """MNIST's four idx files, digit of row i ``i % 10`` shuffled."""
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        _idx(os.path.join(raw, f"{prefix}-images-idx3-ubyte"),
             rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), gz)
        _idx(os.path.join(raw, f"{prefix}-labels-idx1-ubyte"),
             rng.permutation(np.arange(n) % 10), gz)
    return root


def write_svhn(root: str, split: str, n: int, seed: int = 0) -> str:
    """SVHN's ``<split>_32x32.mat``."""
    from scipy import io as sio

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    sio.savemat(os.path.join(root, f"{split}_32x32.mat"),
                {"X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
                 "y": rng.integers(1, 11, (n, 1)).astype(np.uint8)})
    return root


def _caption(rng, words, min_len: int = 8, max_len: int = 24) -> str:
    return " ".join(rng.choice(words, rng.integers(min_len, max_len + 1))) + "."


def write_cub(root: str, n_train: int, n_test: int, seed: int = 0, size=(64, 64),
              n_words: int = 0, n_classes: int = 4) -> str:
    """The ``cub`` folder with ``n_train`` / ``n_test`` images of ``size``
    and 10 captions each; returns root."""
    rng = np.random.default_rng(seed)
    words = np.asarray(list(CUB_WORDS) + [f"w{k}" for k in range(n_words)])
    for split, n, text in (("train", n_train, "text_trainvalclasses.txt"),
                           ("test", n_test, "text_testclasses.txt")):
        for i in range(n):
            folder = os.path.join(root, "cub", split, f"class_{i % n_classes:03d}")
            os.makedirs(folder, exist_ok=True)
            write_png(os.path.join(folder, f"img_{i:05d}.png"),
                      rng.integers(0, 256, (*size, 3), dtype=np.uint8))
        with open(os.path.join(root, "cub", text), "w") as f:
            for _ in range(10 * n):
                f.write(_caption(rng, words) + "\n")
    return root


def write_translated_polymnist(root: str, n: int, n_modalities: int = 5, seed: int = 0,
                               scale: float = 0.75, translate: bool = True,
                               split: str = "train") -> str:
    """A generated Translated PolyMNIST tree of ``n`` rows; returns the
    ``path`` to give ``TranslatedMMNIST``."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, f"Translated_MMNIST_scale_{int(scale * 100)}_translated_"
                              f"{translate}", split)
    digits = rng.integers(0, 10, n)
    for m in range(n_modalities):
        folder = os.path.join(base, f"m{m}")
        os.makedirs(folder, exist_ok=True)
        for i in range(n):
            write_png(os.path.join(folder, f"{i}.{digits[i]}.png"),
                      rng.integers(0, 256, (28, 28, 3), dtype=np.uint8))
    return root
