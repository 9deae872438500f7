"""Device-resident dataset cache: epochs with no per-step host-to-device
copy of the data.

Counterpart of ``multivae_tpu/data/device_cache.py`` on one device. The
dataset (data, masks, labels) is materialized in chunks through its
``get_batch`` and uploaded once; each epoch uploads only the loader's
``epoch_plan`` (the (n_batches, batch) index matrix, as int64, and its
weights), and each batch is an ``index_select`` of the cached rows on the
device. The plan comes from the same seeded permutation as the host
loader's, so the batches are bit-identical to the host ``DataLoader``'s:
data, masks (all ones for a complete dataset), weights, labels and the
``incomplete`` flag. A nested modality (CUB's token dict) is cached leaf by
leaf. The leaves keep their natural shapes (the JAX cache flattens them to
2-D for the TPU's lane tiling).

``build_device_cache`` returns None, with a logged warning, where caching
is unsafe, and the caller then reads from the host loader: the dataset's
estimated size is over the budget, its ``get_batch`` fails on bulk
indexing, or the upload runs out of device memory. The JAX package's
row-sharded and multi-host layouts need a mesh, which the port does not
have yet: on one device ``"sharded"`` counts as replicated, as the JAX
module does for a one-device data axis.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from .batch import MultimodalBatch, map_leaves

logger = logging.getLogger(__name__)

LAYOUTS = ("auto", "replicated", "sharded")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


@dataclasses.dataclass
class DeviceDataCache:
    """The dataset as tensors on one device.

    Attributes:
        data: modality -> (n, *dims) tensor (a dict of them for a nested
            modality).
        masks: modality -> (n,) float32 availability.
        labels: optional (n,) labels.
        incomplete: did the dataset declare masks?
    """

    data: Dict[str, Any]
    masks: Dict[str, torch.Tensor]
    labels: Optional[torch.Tensor] = None
    incomplete: bool = False

    @property
    def device(self) -> torch.device:
        return next(iter(self.masks.values())).device

    def take_rows(self, idx: torch.Tensor):
        """``(data, masks, labels)`` at the rows ``idx`` (an int64 tensor on
        the cache's device)."""
        def take(t):
            return t.index_select(0, idx)

        return ({m: map_leaves(take, v) for m, v in self.data.items()},
                {m: take(v) for m, v in self.masks.items()},
                None if self.labels is None else take(self.labels))

    def rows_to_batch(self, rows, weights: torch.Tensor) -> MultimodalBatch:
        """A ``MultimodalBatch`` of rows from ``take_rows``."""
        data, masks, labels = rows
        return MultimodalBatch(data=data, masks=masks, weights=weights, labels=labels,
                               incomplete=self.incomplete)

    def gather(self, idx: torch.Tensor, weights: torch.Tensor) -> MultimodalBatch:
        """The batch the host ``DataLoader`` makes of the plan row ``idx``."""
        return self.rows_to_batch(self.take_rows(idx), weights)


def upload_plan(loader, device):
    """The loader's current ``epoch_plan`` on ``device``, in a new
    ``PlanBuffer``: (int64 indices, float32 weights), each (n_batches, batch)."""
    return PlanBuffer(loader, device).upload()


class PlanBuffer:
    """A loader's epoch plan held on ``device`` at fixed addresses:
    ``idx`` (n_batches, batch) int64 and ``weights`` float32, which
    ``upload`` overwrites in place with the loader's current
    ``epoch_plan``. A captured CUDA graph that gathers its batches through
    them reads each epoch's plan; on CUDA the copy goes from pinned memory
    without waiting for the device, so it queues behind the epoch before."""

    def __init__(self, loader, device):
        self.loader = loader
        n_batches, batch = len(loader), loader.per_process_batch
        self.idx = torch.empty((n_batches, batch), dtype=torch.int64, device=device)
        self.weights = torch.empty((n_batches, batch), dtype=torch.float32, device=device)

    def upload(self):
        idx, weights = self.loader.epoch_plan()
        for dst, src in ((self.idx, torch.from_numpy(idx.astype(np.int64))),
                         (self.weights, torch.from_numpy(weights))):
            if dst.is_cuda:
                dst.copy_(src.pin_memory(), non_blocking=True)
            else:
                dst.copy_(src)
        return self.idx, self.weights


class DeviceCachedLoader:
    """Drop-in for a DataLoader, yielding batches gathered from a
    ``DeviceDataCache``: the data and masks on the cache's device, the
    weights and labels on the host (the evaluators read them there), all
    bit-identical to the wrapped loader's, from the same ``epoch_plan``.
    Used by the evaluators, whose sweeps read the test set many times."""

    def __init__(self, loader, cache: DeviceDataCache):
        self.loader = loader
        self.cache = cache
        self._labels_host = None if cache.labels is None else cache.labels.cpu()

    @property
    def dataset(self):
        return self.loader.dataset

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        idx_rows, w_rows = self.loader.epoch_plan()
        idx_dev = torch.from_numpy(idx_rows.astype(np.int64)).to(self.cache.device)
        for i in range(len(idx_rows)):
            data, masks, _ = self.cache.take_rows(idx_dev[i])
            labels = (None if self._labels_host is None
                      else self._labels_host[torch.from_numpy(idx_rows[i].astype(np.int64))])
            yield self.cache.rows_to_batch((data, masks, labels),
                                           torch.from_numpy(w_rows[i].copy()))


def estimate_dataset_nbytes(dataset) -> int:
    """Estimated bytes of the materialized dataset (one row through
    ``get_batch``, times its length)."""
    raw = dataset.get_batch(np.asarray([0]))
    per_row = sum(int(np.asarray(leaf).nbytes)
                  for leaf in _leaves({"data": raw["data"], "masks": raw.get("masks"),
                                       "labels": raw.get("labels")}))
    return per_row * len(dataset)


def _check_layout(layout: str):
    if layout not in LAYOUTS:
        raise ValueError(
            f"device cache layout must be 'auto', 'replicated' or 'sharded', got {layout!r}.")


def _resolve_cache_layout(layout: str, est: int, budget_bytes: int) -> Optional[str]:
    """The layout on one device, or None to fall back: every layout keeps
    the whole dataset there, so it fits or it does not."""
    _check_layout(layout)
    return "replicated" if est <= budget_bytes else None


def cache_per_device_nbytes(cache: DeviceDataCache) -> int:
    """The bytes the cache holds on its device."""
    return sum(t.element_size() * t.numel()
               for t in _leaves({"data": cache.data, "masks": cache.masks,
                                 "labels": cache.labels}))


def release_sampler_cache(dataset) -> bool:
    """Drop the device cache a sampler fit memoized on ``dataset``
    (``BaseSampler._collect_latents(device=True)``, or the trainer's cache
    shared there). Returns whether one was attached. Its memory is freed
    once no other reference (a trainer's) holds it."""
    if getattr(dataset, "_sampler_device_cache", None) is not None:
        dataset._sampler_device_cache = None
        return True
    return False


def build_device_cache(dataset, device, budget_bytes: int, chunk: int = 4096,
                       layout: str = "auto") -> Optional[DeviceDataCache]:
    """Materialize ``dataset`` in chunks of ``chunk`` rows and upload it to
    ``device``; None (with a warning) when it does not fit
    ``budget_bytes``, when ``get_batch`` fails on bulk indexing, or when the
    upload runs out of device memory."""
    _check_layout(layout)
    device = torch.device(device)
    try:
        est = estimate_dataset_nbytes(dataset)
    except Exception as e:
        logger.warning("cache_on_device: dataset does not support bulk indexing (%s); "
                       "using the host loader.", e)
        return None
    if _resolve_cache_layout(layout, est, budget_bytes) is None:
        logger.warning("cache_on_device: dataset ~%.2f GB exceeds the device cache budget "
                       "%.2f GB (in every requested layout); using the host loader.",
                       est / 1e9, budget_bytes / 1e9)
        return None

    n = len(dataset)

    def rows(start):
        return dataset.get_batch(np.arange(start, min(start + chunk, n)))

    try:
        first = rows(0)
    except Exception as e:
        logger.warning("cache_on_device: dataset failed bulk indexing (%s); using the "
                       "host loader.", e)
        return None
    incomplete = first.get("masks") is not None

    def alloc(x):
        x = np.asarray(x)
        return torch.empty((n, *x.shape[1:]), dtype=torch.from_numpy(x[:0]).dtype,
                           device=device)

    def fill(dst, src, start):
        src = torch.from_numpy(np.ascontiguousarray(src))
        dst[start:start + len(src)].copy_(src)

    try:
        data = {m: map_leaves(alloc, v) for m, v in first["data"].items()}
        masks = {m: torch.empty(n, dtype=torch.float32, device=device) for m in data}
        labels = None if first.get("labels") is None else alloc(first["labels"])
        part = first
        for start in range(0, n, chunk):
            if start:
                try:
                    part = rows(start)
                except Exception as e:
                    logger.warning("cache_on_device: dataset failed bulk indexing (%s); "
                                   "using the host loader.", e)
                    return None
            for m in data:
                src = part["data"][m]
                for d, s in zip(_leaves(data[m]), _leaves(src)):
                    fill(d, s, start)
                n_rows = len(next(_leaves(src)))
                if incomplete:
                    fill(masks[m], np.asarray(part["masks"][m]).astype(np.float32)
                         .reshape(n_rows), start)
                else:
                    masks[m][start:start + n_rows] = 1.0
            if labels is not None:
                fill(labels, part["labels"], start)
    except torch.cuda.OutOfMemoryError as e:
        logger.warning("cache_on_device: device transfer failed (%s); using the host "
                       "loader.", e)
        return None
    logger.info("cache_on_device: dataset resident on %s (~%.3f GB, %d samples); "
                "epochs run with no per-step host transfers.", device, est / 1e9, n)
    return DeviceDataCache(data=data, masks=masks, labels=labels, incomplete=incomplete)
