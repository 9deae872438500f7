"""Fixed-size batching with wrap-around padding and sample weights.

Counterpart of ``multivae_tpu/data/loader.py``. The epoch permutation
(``np.random.default_rng((seed, epoch))``) and the wrap-around padding of
the last partial batch, with zero weight on the padding rows, are the JAX
loader's, so both packages see the same batches in the same order. Under
data parallelism ``batch_size`` is the global batch and each of
``num_processes`` processes takes its ``per_process_batch`` columns of it,
as the JAX loader's processes do: the padding rows of a partial batch fall
on the last processes. With ``chunks`` > 1 (the trainer's microbatch
chunks) a process takes its share of each of the global batch's chunks
instead, so that chunk c of every process together make chunk c of the
global batch. The evaluators' in-order test loader (``shuffle=False``) takes
the same columns of each test batch on each of their ranks, and a
row-sharded device cache gathers ``global_epoch_plan``'s rows and keeps
``process_columns``. Batches are gathered on the host with numpy and come
out as CPU tensors (a nested modality, such as CUB's token text, as a dict
of them); the trainer moves them to its device.
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
        batch_size: global batch size (across all processes).
        shuffle: reshuffle each epoch with a per-epoch seed.
        seed: base RNG seed for shuffling.
        drop_last: drop the final partial batch instead of padding it.
        num_processes / process_index: data-parallel sharding of each batch.
        chunks: take this process's share of each of ``chunks`` equal
            chunks of the global batch (1: one contiguous block).
    """

    def __init__(self, dataset: MultimodalBaseDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, chunks: int = 1):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.chunks = chunks
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    @property
    def per_process_batch(self) -> int:
        if self.batch_size % self.num_processes:
            raise ValueError(
                f"Global batch size {self.batch_size} must divide evenly over "
                f"{self.num_processes} processes"
            )
        return self.batch_size // self.num_processes

    def process_columns(self) -> np.ndarray:
        """This process's columns of the global batch: the
        ``process_index``-th block of ``per_process_batch``, or with
        ``chunks`` > 1 the ``process_index``-th block of each chunk."""
        local = self.per_process_batch
        if local % self.chunks:
            raise ValueError(f"per-process batch {local} does not divide into "
                             f"{self.chunks} chunks")
        part = local // self.chunks
        width = self.batch_size // self.chunks
        return np.concatenate([c * width + self.process_index * part + np.arange(part)
                               for c in range(self.chunks)])

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
        """``(idx, weights)`` of shape (n_batches, per_process_batch): row b
        holds this process's dataset indices of batch b and their weights (0
        on padding). This is THE definition of an epoch: ``__iter__``
        gathers from it and the device cache uploads it."""
        idx, weights = self.global_epoch_plan()
        if self.num_processes == 1 and self.chunks == 1:
            return idx, weights
        cols = self.process_columns()
        return idx[:, cols], weights[:, cols]

    def global_epoch_plan(self) -> tuple:
        """The epoch plan at the global batch width, the same on every
        process (the permutation derives from the shared seed alone)."""
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
