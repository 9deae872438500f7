"""Fixed-size batching with wrap-around padding and sample weights.

Counterpart of ``multivae_tpu/data/loader.py`` (single process). The
epoch permutation (``np.random.default_rng((seed, epoch))``) and the
wrap-around padding of the last partial batch, with zero weight on the
padding rows, are the JAX loader's, so both packages see the same batches
in the same order. Batches are gathered on the host with numpy and come out
as CPU tensors (a nested modality, such as CUB's token text, as a dict of
them); the trainer moves them to its device.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from .batch import MultimodalBatch, batch_from_arrays
from .datasets.base import MultimodalBaseDataset


class DataLoader:
    """Epoch iterator producing ``MultimodalBatch`` objects.

    Args:
        dataset: a MultimodalBaseDataset (or IncompleteDataset).
        batch_size: rows per batch.
        shuffle: reshuffle each epoch with a per-epoch seed.
        seed: base RNG seed for shuffling.
        drop_last: drop the final partial batch instead of padding it.
    """

    def __init__(self, dataset: MultimodalBaseDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def _epoch_permutation(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self._epoch)).permutation(n)
        return np.arange(n)

    def epoch_plan(self) -> tuple:
        """``(idx, weights)`` of shape (n_batches, batch_size): row b holds
        the dataset indices of batch b and their weights (0 on padding)."""
        perm = self._epoch_permutation()
        bs = self.batch_size
        n_batches = len(self)
        idx_rows = np.empty((n_batches, bs), dtype=np.int32)
        w_rows = np.ones((n_batches, bs), dtype=np.float32)
        for b in range(n_batches):
            idx = perm[b * bs: (b + 1) * bs]
            pad = bs - len(idx)
            if pad:
                # wrap-around padding (cycling if pad > dataset size)
                idx = np.concatenate([idx, np.resize(perm, pad)])
                w_rows[b, bs - pad:] = 0.0
            idx_rows[b] = idx
        return idx_rows, w_rows

    def __iter__(self) -> Iterator[MultimodalBatch]:
        idx_rows, w_rows = self.epoch_plan()
        for idx, w in zip(idx_rows, w_rows):
            raw = self.dataset.get_batch(idx)
            yield batch_from_arrays(
                data=raw["data"], masks=raw.get("masks"),
                labels=raw.get("labels"), weights=w,
            )
