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
estimated size is over the budget in every layout asked for, its
``get_batch`` fails on bulk indexing, or the upload runs out of device
memory. A row-sharded cache falls back on every process of its group
where one process cannot build its block.

Over a process group of N data-parallel processes, one card each (a
``parallel.mesh.DataMesh``), the layouts are the JAX module's: a
*replicated* cache holds the whole set on every card and each process
gathers its own columns of each batch; a row-*sharded* one
(``ShardedDeviceDataCache``) holds one contiguous block of ``ceil(n / N)``
rows on each card, zero past the dataset's end, materialized and uploaded
by that process alone. ``"auto"`` replicates what fits the per-device
budget, else shards what fits N budgets. A sharded step gathers the global
batch's rows: each process takes the rows it holds into a zero buffer of
the batch's size, one all-reduce sums the buffers (exact zeros, summed on
their bytes: ``parallel.shard.sum_exact``), and each keeps its columns, so
the batches are bit-identical to the host loader's. The exchange is one
``all_reduce``, which NCCL runs inside a captured CUDA graph. On one
process ``"sharded"`` counts as replicated, as the JAX module does for a
one-device data axis.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.shard import sum_exact
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

    def _map(self, fn):
        """``(data, masks, labels)`` with ``fn`` applied to each tensor."""
        return ({m: map_leaves(fn, v) for m, v in self.data.items()},
                {m: fn(v) for m, v in self.masks.items()},
                None if self.labels is None else fn(self.labels))

    @staticmethod
    def epoch_plan(loader):
        """``(idx, weights, columns)`` of ``loader``'s current epoch as this
        cache gathers it, as numpy arrays: the plan rows of dataset indices,
        this process's weights of each, and the positions of a plan row
        this process keeps (None: all). A replicated cache reads the
        process's own plan."""
        idx, weights = loader.epoch_plan()
        return idx, weights, None

    def take_rows(self, idx: torch.Tensor, columns: Optional[torch.Tensor] = None):
        """``(data, masks, labels)`` at the rows ``idx`` (an int64 tensor on
        the cache's device, a row of ``epoch_plan``), at the positions
        ``columns`` of it (None: all)."""
        if columns is not None:
            idx = idx.index_select(0, columns)
        return self._map(lambda t: t.index_select(0, idx))

    def host_labels(self) -> Optional[torch.Tensor]:
        """Every dataset row's label on the host (None without labels)."""
        return None if self.labels is None else self.labels.cpu()

    def rows_to_batch(self, rows, weights: torch.Tensor) -> MultimodalBatch:
        """A ``MultimodalBatch`` of rows from ``take_rows``."""
        data, masks, labels = rows
        return MultimodalBatch(data=data, masks=masks, weights=weights, labels=labels,
                               incomplete=self.incomplete)

    def gather(self, idx: torch.Tensor, weights: torch.Tensor,
               columns: Optional[torch.Tensor] = None) -> MultimodalBatch:
        """The batch the host ``DataLoader`` makes of a row of
        ``epoch_plan``: ``idx``, ``weights`` and ``columns`` as it gives them."""
        return self.rows_to_batch(self.take_rows(idx, columns), weights)


@dataclasses.dataclass
class ShardedDeviceDataCache(DeviceDataCache):
    """This process's block of a row-sharded cache: dataset rows
    ``[start, start + block)`` (zero rows past ``n_rows``, the dataset's
    length), the JAX module's ``PartitionSpec("data")`` placement with one
    process per card: over the data axis, replicated over a model axis.
    ``take_rows`` is a collective of every process of ``group`` (the data
    axis's; None: the default group), which holds ``n_blocks`` blocks."""

    n_rows: int = 0
    start: int = 0
    block: int = 0
    n_blocks: int = 1
    group: Optional[object] = None

    @staticmethod
    def epoch_plan(loader):
        """The global plan (every process's rows of each batch), this
        process's weights and its columns."""
        idx, weights = loader.global_epoch_plan()
        columns = loader.process_columns()
        return idx, weights[:, columns], columns

    def take_rows(self, idx: torch.Tensor, columns: Optional[torch.Tensor] = None):
        """This process's ``columns`` of the global batch ``idx`` (a plan row
        at the global batch's width): the rows held here taken into a zero
        buffer of the batch's size, the buffers summed over the group
        (``sum_exact``: bit-identical rows), the columns kept."""
        local = idx - self.start
        own = (local >= 0) & (local < self.block)
        safe = torch.where(own, local, torch.zeros_like(local))
        leaves = []

        def take(t):
            rows = t.index_select(0, safe)
            leaves.append(rows.masked_fill(~own.view(-1, *[1] * (rows.dim() - 1)), 0))
            return len(leaves) - 1

        positions = self._map(take)
        summed = sum_exact(leaves, self.group)
        if columns is not None:
            summed = [t.index_select(0, columns) for t in summed]
        data, masks, labels = positions
        return ({m: map_leaves(lambda i: summed[i], v) for m, v in data.items()},
                {m: summed[i] for m, i in masks.items()},
                None if labels is None else summed[labels])

    def host_labels(self) -> Optional[torch.Tensor]:
        """Every dataset row's label on the host, gathered from every
        process's block (a collective)."""
        if self.labels is None:
            return None
        full = self.labels.new_zeros((self.block * self.n_blocks, *self.labels.shape[1:]))
        full[self.start:self.start + self.block] = self.labels
        return sum_exact([full], self.group)[0][:self.n_rows].cpu()

    def exchange_nbytes(self, batch: int) -> int:
        """The bytes one step's all-reduce sums on each process, for a
        global batch of ``batch`` rows."""
        return batch * sum(t[:1].numel() * t.element_size()
                           for t in _leaves({"data": self.data, "masks": self.masks,
                                             "labels": self.labels}))


def upload_plan(loader, device):
    """The loader's current ``epoch_plan`` on ``device``, in a new
    ``PlanBuffer``: (int64 indices, float32 weights), each (n_batches, batch)."""
    return PlanBuffer(loader, device).upload()


class PlanBuffer:
    """A loader's epoch plan held on ``device`` at fixed addresses:
    ``idx`` and ``weights`` (n_batches, width) int64 and float32, which
    ``upload`` overwrites in place with the plan of the loader's current
    epoch, and ``columns``: the three of ``cache.epoch_plan`` (the
    loader's own plan without a cache). A captured CUDA graph that gathers
    its batches through them reads each epoch's plan; on CUDA the copy goes
    from pinned memory without waiting for the device, so it queues behind
    the epoch before."""

    def __init__(self, loader, device, cache: Optional[DeviceDataCache] = None):
        self.loader = loader
        self._plan = (DeviceDataCache if cache is None else cache).epoch_plan
        idx, weights, columns = self._plan(loader)
        self.idx = torch.empty(idx.shape, dtype=torch.int64, device=device)
        self.weights = torch.empty(weights.shape, dtype=torch.float32, device=device)
        self.columns = (None if columns is None
                        else torch.from_numpy(columns.astype(np.int64)).to(device))

    def upload(self):
        idx, weights, _ = self._plan(self.loader)
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
    Used by the evaluators, whose sweeps read the test set many times. A
    row-sharded cache gathers each global batch over the group; its labels
    are gathered to the host once, when the loader is made."""

    def __init__(self, loader, cache: DeviceDataCache):
        self.loader = loader
        self.cache = cache
        self._labels_host = cache.host_labels()

    @property
    def dataset(self):
        return self.loader.dataset

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        idx_rows, w_rows, cols = self.cache.epoch_plan(self.loader)
        own = idx_rows if cols is None else idx_rows[:, cols]
        idx_dev = torch.from_numpy(idx_rows.astype(np.int64)).to(self.cache.device)
        columns = (None if cols is None
                   else torch.from_numpy(cols.astype(np.int64)).to(self.cache.device))
        for i in range(len(idx_rows)):
            data, masks, _ = self.cache.take_rows(idx_dev[i], columns)
            labels = (None if self._labels_host is None
                      else self._labels_host[torch.from_numpy(own[i].astype(np.int64))])
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


def _resolve_cache_layout(layout: str, est: int, budget_bytes: int,
                          n_data: int = 1) -> Optional[str]:
    """The layout over ``n_data`` processes, or None to fall back (JAX
    ``_resolve_cache_layout``): ``budget_bytes`` is a per-device budget,
    which a replicated cache takes ``est`` of and a sharded one ``est /
    n_data``; "auto" prefers replicated and falls to sharded where only
    that fits; on one process every layout is replicated."""
    _check_layout(layout)
    fits_rep = est <= budget_bytes
    fits_shard = n_data > 1 and est <= budget_bytes * n_data
    if layout == "replicated" or n_data == 1:
        return "replicated" if fits_rep else None
    if layout == "sharded":
        return "sharded" if fits_shard else None
    if fits_rep:
        return "replicated"
    if fits_shard:
        logger.info("cache_on_device: dataset ~%.2f GB exceeds the per-device budget %.2f GB; "
                    "caching row-sharded over %d processes (~%.2f GB each).", est / 1e9,
                    budget_bytes / 1e9, n_data, est / n_data / 1e9)
        return "sharded"
    return None


def cache_per_device_nbytes(cache: DeviceDataCache) -> int:
    """The bytes the cache holds on its device (a sharded cache's block)."""
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


def _all_processes_agree(ok: bool, device) -> bool:
    """Is ``ok`` true on every process of the default group?"""
    failed = torch.tensor([0 if ok else 1], dtype=torch.int32, device=device)
    dist.all_reduce(failed)
    return int(failed.item()) == 0


def _materialize(dataset, device, lo: int, hi: int, n_alloc: int, chunk: int, zero: bool):
    """Rows ``[lo, hi)`` of ``dataset`` uploaded to ``device`` in chunks of
    ``chunk``, into ``n_alloc`` rows (zero past ``hi - lo`` where ``zero``):
    ``(data, masks, labels, incomplete)``, or None (with a warning) when
    ``get_batch`` fails on bulk indexing or the upload runs out of device
    memory."""

    def rows(start):
        return dataset.get_batch(np.arange(start, min(start + chunk, hi)))

    try:
        # a process that holds only padding rows reads one row for the shapes
        first = rows(lo) if hi > lo else dataset.get_batch(np.asarray([0]))
    except Exception as e:
        logger.warning("cache_on_device: dataset failed bulk indexing (%s); using the "
                       "host loader.", e)
        return None
    incomplete = first.get("masks") is not None
    new = torch.zeros if zero else torch.empty

    def alloc(x):
        x = np.asarray(x)
        return new((n_alloc, *x.shape[1:]), dtype=torch.from_numpy(x[:0]).dtype, device=device)

    def fill(dst, src, start):
        src = torch.from_numpy(np.ascontiguousarray(src))
        dst[start - lo:start - lo + len(src)].copy_(src)

    try:
        data = {m: map_leaves(alloc, v) for m, v in first["data"].items()}
        masks = {m: new(n_alloc, dtype=torch.float32, device=device) for m in data}
        labels = None if first.get("labels") is None else alloc(first["labels"])
        part = first
        for start in range(lo, hi, chunk):
            if start > lo:
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
                    masks[m][start - lo:start - lo + n_rows] = 1.0
            if labels is not None:
                fill(labels, part["labels"], start)
    except torch.cuda.OutOfMemoryError as e:
        logger.warning("cache_on_device: device transfer failed (%s); using the host "
                       "loader.", e)
        return None
    return data, masks, labels, incomplete


def build_device_cache(dataset, device, budget_bytes: int, chunk: int = 4096,
                       layout: str = "auto", mesh=None) -> Optional[DeviceDataCache]:
    """Materialize ``dataset`` in chunks of ``chunk`` rows and upload it to
    ``device``; None (with a warning) when it does not fit
    ``budget_bytes`` in the layout asked for, when ``get_batch`` fails on
    bulk indexing, or when the upload runs out of device memory. ``mesh``
    (a ``DataMesh``: the processes of data-parallel training or
    evaluation) sets the layouts' rules; a sharded cache is built by every
    process of the group at once, each materializing its block only, and
    where one process cannot build its block every process falls back
    (a sharded step is a collective of all of them)."""
    _check_layout(layout)
    device = torch.device(device)
    n_data = mesh.n_data if mesh is not None and mesh.distributed else 1
    try:
        est = estimate_dataset_nbytes(dataset)
    except Exception as e:
        logger.warning("cache_on_device: dataset does not support bulk indexing (%s); "
                       "using the host loader.", e)
        return None
    layout = _resolve_cache_layout(layout, est, budget_bytes, n_data)
    if layout is None:
        logger.warning("cache_on_device: dataset ~%.2f GB exceeds the device cache budget "
                       "%.2f GB (in every requested layout); using the host loader.",
                       est / 1e9, budget_bytes / 1e9)
        return None

    n = len(dataset)
    if layout == "replicated":
        built = _materialize(dataset, device, 0, n, n, chunk, zero=False)
        if built is None:
            return None
        data, masks, labels, incomplete = built
        logger.info("cache_on_device: dataset resident on %s (~%.3f GB, %d samples, "
                    "replicated); epochs run with no per-step host transfers.", device,
                    est / 1e9, n)
        return DeviceDataCache(data=data, masks=masks, labels=labels, incomplete=incomplete)

    # the block of ceil(n / N) rows this process materializes, zero past n
    block = -(-n // n_data)
    lo = min(mesh.data_index * block, n)
    hi = min(lo + block, n)
    built = _materialize(dataset, device, lo, hi, block, chunk, zero=True)
    if not _all_processes_agree(built is not None, mesh.device):
        if built is not None:
            logger.warning("cache_on_device: another process could not build its block of "
                           "the row-sharded cache; using the host loader.")
        return None
    data, masks, labels, incomplete = built
    logger.info("cache_on_device: dataset resident on %s (~%.3f GB, %d samples, rows %d-%d "
                "of a row-sharded cache); epochs run with no per-step host transfers.",
                device, est / 1e9, n, lo, hi)
    return ShardedDeviceDataCache(data=data, masks=masks, labels=labels, incomplete=incomplete,
                                  n_rows=n, start=mesh.data_index * block, block=block,
                                  n_blocks=n_data, group=mesh.data_group)
