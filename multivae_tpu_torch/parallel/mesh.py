"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``multivae_tpu/parallel/mesh.py``. The JAX package puts the
global batch on a one-axis device mesh and lets XLA insert the gradient
all-reduce; the port runs one process per card, each with a replica of the
model and its own columns of every global batch, and sums the replicas'
gradients with one collective a step:

- ``maybe_init_distributed`` opens the default process group: from the
  trainer's ``coordinator_address`` / ``num_processes`` / ``process_id``, or
  from torchrun's ``env://`` variables. NCCL where the trainer runs on CUDA,
  gloo on the CPU, unless the caller names a backend. It does nothing for a
  process that is alone, or where a group already exists (a caller may open
  one itself, over gloo on a card for instance).
- ``get_data_mesh`` describes this process's place in the group and its card
  (``cuda:<local rank mod the visible cards>``).
- ``shard_batch`` takes this process's rows of a global batch.
- ``GradientReducer`` sums the gradients over the group: a one-byte presence
  mask first, on the host (a gradient that is None on every rank stays
  None, one that is None on some ranks only counts as zeros there), then
  one flat buffer a dtype, one ``all_reduce`` each. Inside a CUDA graph's
  capture it reuses the mask of its last eager call: a graph replays the
  parameter set of its capture.
- ``broadcast_module`` copies rank 0's weights to the other ranks.

The JAX module's FSDP and tensor-parallel sharding specs
(``fsdp_state_sharding``, ``tp_state_sharding``,
``combined_state_sharding``) have no counterpart yet (ROADMAP, Queue A).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from ..data.batch import MultimodalBatch, map_leaves

logger = logging.getLogger(__name__)

# a collective that never finds its partners fails after this long
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

ONE_PROCESS_PER_CARD = (
    "The port runs one process per card: launch N processes, with torchrun "
    "(`torchrun --nproc-per-node N script.py`) or with the trainer's "
    "coordinator_address, num_processes and process_id on each.")


def maybe_init_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device="cuda") -> bool:
    """Open the default process group where one is asked for; returns
    whether a group exists afterwards.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) and
    takes ``num_processes`` and this ``process_id``. Without it, torchrun's
    ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` are read
    when ``WORLD_SIZE`` is above 1. ``backend`` None means NCCL for a CUDA
    ``device`` and gloo for the CPU. Its collectives time out after
    ``DEFAULT_TIMEOUT``. An existing group is kept as it is."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None and (num_processes or 1) > 1:
        if process_id is None:
            raise ValueError("coordinator_address and num_processes need this "
                             "process's process_id.")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=DEFAULT_TIMEOUT)
    logger.info("Joined the %s process group: rank %d of %d", backend, rank, world)
    return True


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in data-parallel training.

    ``distributed`` says whether a process group carries the collectives
    (it may hold one process); ``device`` is this process's card (or the
    CPU)."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    distributed: bool

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.distributed else None


def get_data_mesh(n_devices: Optional[int] = None, device="cuda") -> DataMesh:
    """The data mesh of this process: the default group's size and rank, or
    one process alone. ``n_devices`` counts processes, one card each (None:
    the group's size); a value the group does not match raises, as does
    ``n_devices > 1`` without a group. A CUDA ``device`` without an index
    becomes ``cuda:<local rank mod the visible cards>``, so two ranks on a
    one-card machine share ``cuda:0``."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if n_devices is not None and n_devices > 1:
            raise ValueError(f"n_devices={n_devices} but no process group exists. "
                             + ONE_PROCESS_PER_CARD)
        return DataMesh(1, 0, 0, dev, False)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group holds {world} "
                         "processes. " + ONE_PROCESS_PER_CARD)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return DataMesh(world, rank, local_rank, dev, True)


def shard_batch(batch: MultimodalBatch, mesh: DataMesh) -> MultimodalBatch:
    """This process's rows of a global batch: the ``rank``-th of
    ``world_size`` equal blocks."""
    n = batch.n_samples
    if n % mesh.world_size:
        raise ValueError(f"global batch of {n} rows does not divide over "
                         f"{mesh.world_size} processes")
    size = n // mesh.world_size
    lo = mesh.rank * size

    def rows(t):
        return None if t is None else t[lo:lo + size]

    return MultimodalBatch(data={k: map_leaves(rows, v) for k, v in batch.data.items()},
                           masks={k: rows(v) for k, v in batch.masks.items()},
                           weights=rows(batch.weights), labels=rows(batch.labels),
                           incomplete=batch.incomplete)


def capturing(device) -> bool:
    """Is ``device``'s current stream capturing a CUDA graph?"""
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def _flat_by_dtype(tensors: List[torch.Tensor]):
    """{dtype: tensors of that dtype}, in order."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def broadcast_module(module: torch.nn.Module, src: int = 0):
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module``: one flat ``broadcast`` a dtype."""
    tensors = [t for t in list(module.parameters()) + list(module.buffers())
               if t.numel()]
    with torch.no_grad():
        for group in _flat_by_dtype(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src)
            torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in group]), group)])


class GradientReducer:
    """Sums the gradients of ``params`` over the default group, in place.

    Each call makes two collectives: the presence of each gradient (a
    uint8 mask on the host, MAX-reduced through a gloo group beside an
    NCCL one, so that nothing waits for the card), then the present
    gradients in one flat buffer a dtype, SUM-reduced. A gradient None on
    every rank stays None, so the optimizer skips its parameter as it would
    in one process; one None on some ranks only joins as zeros there. After
    the call each present gradient is a view of its flat buffer, which the
    next call reuses: the trainer sets the gradients to None before each
    step's backward.

    Inside a CUDA graph's capture (the trainer's chunks under NCCL) the
    host cannot take part, so the call skips the mask and reuses the one
    of its last eager call: the eager chunk the trainer runs before every
    capture (``ChunkGraphs``). A graph replays the parameter set of its
    capture, and the flat buffers keep their addresses, so each replay
    sums the gradients of the same parameters into the same memory. A
    capture with no eager call before it raises."""

    def __init__(self, params, device):
        self.params = list(params)
        self.device = torch.device(device)
        # a collective of every rank: each builds its reducer at once
        self._mask_group = None if dist.get_backend() == "gloo" else dist.new_group(
            backend="gloo")
        self._buffers = {}
        self._present = None      # the last eager call's, which a capture reuses
        self.bytes_reduced = 0    # of the last call

    def __call__(self):
        params = self.params
        if capturing(self.device):
            if self._present is None:
                raise RuntimeError("GradientReducer: a CUDA graph captured the gradient "
                                   "all-reduce before any eager step took its presence mask")
            present = self._present
        else:
            mask = torch.tensor([p.grad is not None for p in params], dtype=torch.uint8)
            dist.all_reduce(mask, op=dist.ReduceOp.MAX, group=self._mask_group)
            present = self._present = [p for p, flag in zip(params, mask.tolist()) if flag]
        self.bytes_reduced = 0
        with torch.no_grad():
            for dtype, group in _flat_by_dtype(present).items():
                sizes = [p.numel() for p in group]
                key = tuple(id(p) for p in group)
                if self._buffers.get(dtype, (None,))[0] != key:
                    self._buffers[dtype] = (key, torch.empty(
                        sum(sizes), dtype=dtype, device=self.device))
                flat = self._buffers[dtype][1]
                views = [v.view_as(p) for v, p in zip(flat.split(sizes), group)]
                have = [(v, p.grad) for v, p in zip(views, group) if p.grad is not None]
                if len(have) < len(group):
                    flat.zero_()
                if have:
                    torch._foreach_copy_([v for v, _ in have], [g for _, g in have])
                dist.all_reduce(flat, op=dist.ReduceOp.SUM)
                self.bytes_reduced += flat.numel() * flat.element_size()
                for v, p in zip(views, group):
                    p.grad = v
