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
  (``cuda:<local rank mod the visible cards>``): a data axis, and with
  ``n_model_devices`` K > 1 a model axis of K adjacent ranks (rank r is data
  index r // K and model index r % K, the JAX layout), with a process group
  for each axis.
- ``shard_batch`` takes this process's rows of a global batch.
- ``broadcast_module`` copies rank 0's weights to the other ranks.
- ``combined_state_sharding`` (and its halves ``fsdp_state_sharding`` and
  ``tp_state_sharding``) gives each leaf of a tree the JAX package's spec:
  the same rule on the same shapes. ``param_placements`` judges each
  parameter of a torch model on the leaf as the JAX package shapes it (the
  axes of ``utils/convert.py``, or the layout a module declares for a leaf
  that the conversion reshapes) and gives the spec in the torch axes.
  ``parallel/state.py`` keeps the train state by these placements and sums
  the gradients over the group (every leaf whole without ``fsdp`` or a
  model axis: one flat all-reduce a dtype).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..data.batch import MultimodalBatch, map_leaves

logger = logging.getLogger(__name__)

# a collective that never finds its partners fails after this long
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)

DATA_AXIS, MODEL_AXIS = "data", "model"

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
    CPU). The ``world_size`` processes form a (data, model) grid of
    ``n_data`` x ``n_model``: rank r is data index r // n_model and model
    index r % n_model. ``data_group`` holds the ranks of this model index
    (None: the default group, where ``n_model`` is 1) and ``model_group``
    the ranks of this data index (None where ``n_model`` is 1)."""

    world_size: int
    rank: int
    local_rank: int
    device: torch.device
    distributed: bool
    n_model: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def is_main_process(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.distributed else None

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def _axis_groups(world: int, n_model: int, rank: int):
    """(this rank's data group, its model group), made on every rank in the
    same order: the data groups ``{d * K + k}`` for each model index k, then
    the model groups ``{d * K .. d * K + K - 1}`` for each data index d."""
    data = model = None
    for k in range(n_model):
        group = dist.new_group(list(range(k, world, n_model)))
        if rank % n_model == k:
            data = group
    for d in range(world // n_model):
        group = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
        if rank // n_model == d:
            model = group
    return data, model


def get_data_mesh(n_devices: Optional[int] = None, device="cuda",
                  n_model_devices: int = 1) -> DataMesh:
    """The mesh of this process: the default group's size and rank, or one
    process alone. ``n_devices`` counts the data axis, as in the JAX
    package (None: the group's size over ``n_model_devices``); the group
    must hold ``n_devices * n_model_devices`` processes, one card each, or
    this raises, as does a world that ``n_model_devices`` does not divide
    and ``n_devices`` or ``n_model_devices`` above 1 without a group. A
    CUDA ``device`` without an index becomes ``cuda:<local rank mod the
    visible cards>``, so two ranks on a one-card machine share ``cuda:0``."""
    dev = torch.device(device)
    k = n_model_devices
    if not dist.is_initialized():
        if (n_devices is not None and n_devices > 1) or k > 1:
            raise ValueError(f"n_devices={n_devices}, n_model_devices={k} but no process "
                             "group exists. " + ONE_PROCESS_PER_CARD)
        return DataMesh(1, 0, 0, dev, False)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % k:
        raise ValueError(f"{world} devices do not factor over n_model_devices={k}.")
    if n_devices is not None and n_devices * k != world:
        wanted = f"n_devices={n_devices}" + (f" x n_model_devices={k}" if k > 1 else "")
        raise ValueError(f"{wanted} but the process group holds {world} processes. "
                         + ONE_PROCESS_PER_CARD)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    data_group = model_group = None
    if k > 1:
        data_group, model_group = _axis_groups(world, k, rank)
    return DataMesh(world, rank, local_rank, dev, True, k, data_group, model_group)


# ------------------------------------------------------------ the leaf rule
def _leaf_spec(shape, floating: bool, n_data: int, n_model: int, fsdp: bool,
               min_size: int, min_dim: int) -> tuple:
    """The JAX ``combined_state_sharding`` spec of one leaf, as a tuple of
    axis names or None a dimension (``()``: replicated)."""
    shape = tuple(shape)
    if not (len(shape) >= 1 and floating):
        return ()
    dims = [None] * len(shape)
    tp = n_model > 1
    col_ok = tp and shape[-1] % n_model == 0 and shape[-1] >= min_dim
    big = fsdp and shape[0] % n_data == 0 and math.prod(shape) >= min_size
    if len(shape) == 1:
        # a bias-like leaf follows its kernel's output columns first
        if col_ok:
            dims[-1] = MODEL_AXIS
        elif big:
            dims[0] = DATA_AXIS
    else:
        if big:
            dims[0] = DATA_AXIS
        if col_ok and dims[-1] is None:
            dims[-1] = MODEL_AXIS
    return () if all(d is None for d in dims) else tuple(dims)


def _is_floating(x) -> bool:
    dtype = getattr(x, "dtype", torch.float32)
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    import numpy as np

    return bool(np.issubdtype(dtype, np.floating))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def combined_state_sharding(state, mesh, fsdp: bool = False, min_size: int = 1024,
                            min_dim: int = 64):
    """The spec of each leaf of ``state`` (nested dicts, lists or tuples of
    arrays or tensors, shaped as the JAX package shapes its leaves) on
    ``mesh`` (``n_data`` x ``n_model``), JAX ``combined_state_sharding``:
    with ``fsdp``, a float leaf whose first axis ``n_data`` divides and
    that holds ``min_size`` entries or more is cut on that axis over
    "data"; on a model axis, a float leaf whose last axis ``n_model``
    divides and is ``min_dim`` wide or more is cut on it over "model"; a
    1-D leaf takes the column rule before the fsdp one; integer leaves stay
    replicated. Each spec is a tuple of "data", "model" or None a
    dimension, ``()`` for a replicated leaf."""
    return _map_tree(lambda x: _leaf_spec(
        getattr(x, "shape", ()), _is_floating(x), mesh.n_data, mesh.n_model, fsdp,
        min_size, min_dim), state)


def fsdp_state_sharding(state, mesh, min_size: int = 1024):
    """JAX ``fsdp_state_sharding``: the data axis of the rule alone (a leaf
    cut on its first axis over "data", or replicated)."""
    return _map_tree(lambda x: _leaf_spec(
        getattr(x, "shape", ()), _is_floating(x), mesh.n_data, 1, True, min_size, 0), state)


def tp_state_sharding(state, mesh, min_dim: int = 64):
    """JAX ``tp_state_sharding``: the model axis of the rule alone; raises
    on a mesh without a model axis, as the JAX function does."""
    if mesh.n_model <= 1:
        raise ValueError(f"tp_state_sharding needs a mesh with a '{MODEL_AXIS}' axis; "
                         f"got n_model={mesh.n_model}.")
    return combined_state_sharding(state, mesh, fsdp=False, min_dim=min_dim)


def jax_view(module: torch.nn.Module, name: str, param: torch.Tensor,
             declared: Optional[dict] = None) -> tuple:
    """``(shape, groups)``: the shape of the JAX leaf that ``module``'s
    parameter ``name`` converts from (``utils/convert.py``), and for each
    torch axis the JAX axes merged into it, in order. A leaf a module
    declares (``declared``, from ``declared_leaves``) is read as declared;
    else a Dense kernel (in, out) is a Linear weight (out, in), a conv
    kernel HWIO an OIHW weight, a ConvTranspose kernel (kh, kw, in, out) an
    (in, out, kh, kw) weight, each torch axis one JAX axis; every other
    leaf (biases, norms, embeddings, a model's own parameters) keeps its
    axes."""
    if declared and (id(module), name) in declared:
        shape, groups = declared[(id(module), name)]
        merged = [math.prod(shape[j] for j in group) for group in groups]
        if merged != list(param.shape):
            raise ValueError(f"{type(module).__name__}.{name}: the declared JAX leaf {shape} "
                             f"merges to {merged}, not the parameter's {list(param.shape)}")
        return shape, groups
    axes = tuple(range(param.dim()))       # the torch axis of each JAX axis
    if name == "weight" and param.dim() >= 2:
        for child_of, perm in ((torch.nn.Linear, (1, 0)), (torch.nn.Conv2d, (2, 3, 1, 0)),
                               (torch.nn.ConvTranspose2d, (2, 3, 0, 1))):
            if isinstance(module, child_of):
                axes = perm
                break
    return (tuple(param.shape[a] for a in axes),
            tuple((axes.index(t),) for t in range(param.dim())))


def declared_leaves(model: torch.nn.Module) -> dict:
    """``{(id(module), attribute): (shape, groups)}`` of the parameters
    whose JAX leaves a module of ``model`` declares through its
    ``jax_leaves()`` (the CUB text encoder's attention projections,
    reshapes of Flax's per-head leaves: ``nn/cub.py``)."""
    out = {}
    for module in model.modules():
        if hasattr(module, "jax_leaves"):
            for key, view in module.jax_leaves().items():
                path, _, attr = key.rpartition(".")
                out[(id(module.get_submodule(path)), attr)] = view
    return out


def param_owners(model: torch.nn.Module):
    """``[(name, parameter, [(module, attribute), ...])]`` in
    ``named_parameters`` order: every module holding each parameter (a
    tied parameter has several)."""
    owners = {}
    for module in model.modules():
        for attr, p in module._parameters.items():
            if p is not None:
                owners.setdefault(id(p), []).append((module, attr))
    return [(name, p, owners[id(p)]) for name, p in model.named_parameters()]


def param_placements(model: torch.nn.Module, mesh, fsdp: bool = False,
                     min_size: int = 1024, min_dim: int = 64) -> dict:
    """``{parameter name: spec in the torch axes}``: each parameter judged by
    ``combined_state_sharding`` on its JAX leaf's shape (``jax_view``), and
    each JAX axis's name written on the torch axis that holds it. A torch
    axis holding two cut JAX axes takes both names as a tuple entry, as
    JAX's ``P(("data", "model"))``. Along such a merged axis the JAX rule
    gives the axes that are cut and each rank's share; which elements a
    rank holds is ``parallel/state.py``'s choice (a Linear's contiguous
    output rows, a flat piece of the data axis)."""
    out = {}
    declared = declared_leaves(model)
    for key, p, holders in param_owners(model):
        module, name = holders[0]
        if not fsdp and mesh.n_model == 1:   # nothing to cut: every leaf whole
            out[key] = ()
            continue
        shape, groups = jax_view(module, name, p, declared)
        spec = _leaf_spec(shape, p.is_floating_point(), mesh.n_data, mesh.n_model, fsdp,
                          min_size, min_dim)
        if not spec:
            out[key] = ()
            continue
        torch_spec = []
        for group in groups:
            names = tuple(spec[j] for j in group if spec[j] is not None)
            torch_spec.append(names[0] if len(names) == 1 else names or None)
        out[key] = tuple(torch_spec)
    return out


def shard_batch(batch: MultimodalBatch, mesh: DataMesh) -> MultimodalBatch:
    """This process's rows of a global batch: the ``data_index``-th of
    ``n_data`` equal blocks (the ranks of a model group take the same)."""
    n = batch.n_samples
    if n % mesh.n_data:
        raise ValueError(f"global batch of {n} rows does not divide over "
                         f"{mesh.n_data} processes")
    size = n // mesh.n_data
    lo = mesh.data_index * size

    def rows(t):
        return None if t is None else t[lo:lo + size]

    return MultimodalBatch(data={k: map_leaves(rows, v) for k, v in batch.data.items()},
                           masks={k: rows(v) for k, v in batch.masks.items()},
                           weights=rows(batch.weights), labels=rows(batch.labels),
                           incomplete=batch.incomplete)


def capturing(device) -> bool:
    """Is ``device``'s current stream capturing a CUDA graph?"""
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def _flat_by_dtype(items, tensor_of=lambda t: t):
    """{dtype: the items whose tensor (``tensor_of(item)``) has it}, in order."""
    groups = {}
    for item in items:
        groups.setdefault(tensor_of(item).dtype, []).append(item)
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
