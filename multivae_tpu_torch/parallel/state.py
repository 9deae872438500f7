"""The train state by ``combined_state_sharding``'s placements: the JAX
package's ``fsdp`` and ``n_model_devices`` (``trainers/base/base_trainer.py``
``_state_sharding`` / ``_params_sharding``) on a process mesh, one process
per card, and the gradients' sum over the group. Without ``fsdp`` or a
model axis every leaf stays whole and a step's reduction is one flat
all-reduce a dtype over the group (plain data parallelism).

The JAX package places each leaf of its train state (parameters and the
optimizer's moments alike) and lets XLA put in the collectives. The port
keeps each parameter by its placement (``mesh.param_placements``) and runs
the collectives itself, on flat buffers, one a dtype and an axis:

- A leaf cut over "data" (``fsdp``) keeps, at rest, only this rank's
  1/``n_data`` of its (column) tensor as a flat float32 master, which the
  optimizer steps; its moments follow. The port cuts the flattened tensor
  into ``n_data`` contiguous pieces (the axis does not touch the math; the
  set of cut leaves and their share are the JAX rule's).
- A Linear, Conv2d or ConvTranspose2d whose weight is cut over "model"
  computes its own output columns (channels) from its weight and bias
  shards and the activation is gathered over the model axis before the
  next layer (``column_forward``); the backward sums the ranks' partial
  input gradients over the model axis. Any other leaf cut over "model" is
  kept as this rank's 1/``n_model`` piece and gathered at use.
- Every other leaf stays whole on every rank (the module's own parameter).

A leaf whose JAX form is a reshape of the torch tensor (the CUB text
encoder's per-head attention projections) is cut where the JAX rule cuts
its JAX axes: a spec entry of a torch axis that merges two cut JAX axes
names both. The bytes a rank holds and the axes that are cut are JAX's;
which elements along a merged axis is the port's choice, as on the data
axis. A query projection cut over "model" computes its own contiguous
output rows (whole heads where the model axis divides the heads), where
JAX gives each rank a head_dim slice of every head: the gathered
activations are the same tensor.

The modules hold the masters only inside ``reshard`` ... ``unshard`` (the
trainer's ``train``): outside, they hold whole weights, plain. A step runs
inside ``gathered``: the cut leaves' masters are all-gathered
(over "data", then over "model") into the tensors the modules compute
with, swapped in where the modules hold them. After the backward the
ShardedState, called as the trainer's gradient reducer, reduce-scatters
the gradients of the leaves cut over "data" into their masters' and
all-reduces the others' over "data" (a leaf cut over "model" first keeps
its own piece of the gradient, the same on every model rank); then the
optimizer steps the masters. Each reduction takes a presence mask first,
on the host (a gradient None on every rank stays None, so the optimizer
skips its parameter as it would in one process; one None on some ranks
only joins as zeros there). Inside a CUDA graph's capture the host cannot
take part: the call reuses the mask of its last eager call (the eager
chunk before each capture, ``ChunkGraphs``), since a graph replays the
parameter set of its capture, and its output buffers keep their
addresses. Under NCCL the collectives are ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_reduce``, which a CUDA graph captures;
under gloo (which has no gather or scatter for CUDA tensors) the gathers go
through ``shard.sum_exact`` and the scatters through an ``all_reduce``. A
process alone (no group) keeps the same layout over axes of one and copies.

Whole weights (``whole_state_dict``), whole optimizer state
(``optimizer_state_whole``) and their inverses (``load_whole``,
``load_optimizer_whole``) convert to and from what a replicated run holds,
keys and shapes alike: the msgpack checkpoints and the kept weights stay
whole. The sharded checkpoints (``trainers/base/checkpoint.py``) write
each master where ``place`` puts it in its leaf, one rank a distinct piece
(``pieces``), and read them back into any layout through ``load_leaf``
and ``_shard_of``, with no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    _flat_by_dtype,
    capturing,
    param_owners,
    param_placements,
)
from .shard import sum_exact

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# the modules whose output columns the port computes from the weight's
# shard: their forward -> the axis of their weight's output features
_COLUMN_FORWARDS = {nn.Linear.forward: 0, nn.Conv2d.forward: 0, nn.ConvTranspose2d.forward: 1}


class _Axis:
    """One axis of the mesh: its group, size and this rank's index on it.
    ``run`` is False for a process alone, whose collectives are copies."""

    def __init__(self, group, size: int, index: int, run: bool, nccl: bool):
        self.group, self.size, self.index, self.run, self.nccl = group, size, index, run, nccl

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor):
        """``out`` (size x n) = every rank's ``inp`` (n) in index order."""
        if not self.run:
            out.copy_(inp)
        elif self.nccl:
            _all_gather(out, inp, group=self.group)
        else:
            out.zero_()
            out.view(self.size, -1)[self.index].copy_(inp)
            out.copy_(sum_exact([out], self.group)[0])

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor):
        """``out`` (n) = this rank's block of the SUM of every rank's ``inp``
        (size x n), which it may overwrite."""
        if not self.run:
            out.copy_(inp)
        elif self.nccl:
            _reduce_scatter(out, inp, op=dist.ReduceOp.SUM, group=self.group)
        else:
            self.all_reduce(inp)
            out.copy_(inp.view(self.size, -1)[self.index])

    def all_reduce(self, t: torch.Tensor):
        """SUM ``t`` in place over the axis."""
        if self.run:
            dist.all_reduce(t, group=self.group)


class _ToColumns(torch.autograd.Function):
    """A column layer's input: the identity forward; the backward sums the
    model ranks' partial input gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.axis.all_reduce(grad)
        return grad, None


class _FromColumns(torch.autograd.Function):
    """A column layer's output: every model rank's columns gathered on
    ``dim``; the backward keeps this rank's (the gradient of the whole
    output is the same on every model rank)."""

    @staticmethod
    def forward(ctx, y, dim, axis):
        ctx.dim, ctx.axis, ctx.width = dim, axis, y.shape[dim]
        y = y.contiguous()
        out = y.new_empty(axis.size * y.numel())
        axis.all_gather(out, y.reshape(-1))
        out = out.view(axis.size, *y.shape).movedim(0, dim)
        return out.reshape(*y.shape[:dim], axis.size * y.shape[dim], *y.shape[dim + 1:])

    @staticmethod
    def backward(ctx, grad):
        width = ctx.width
        return grad.narrow(ctx.dim, ctx.axis.index * width, width).contiguous(), None, None


def column_forward(module: nn.Module, axis: _Axis, state: "ShardedState"):
    """``module``'s forward on its column shards: its own forward on the
    input (whose gradient the model ranks sum), the output gathered on the
    feature axis (the last for a Linear, the channels for a convolution).
    Inside ``ShardedState.whole_weights`` (whole weights swapped in) it is
    the plain forward."""
    plain = type(module).forward

    def forward(x, *args, **kwargs):
        if not state.columns_on:
            return plain(module, x, *args, **kwargs)
        y = plain(module, _ToColumns.apply(x, axis), *args, **kwargs)
        dim = y.dim() - 1 if isinstance(module, nn.Linear) else 1
        return _FromColumns.apply(y, dim, axis)

    return forward


@dataclasses.dataclass(eq=False)
class _Leaf:
    """One parameter and its placement."""

    name: str
    owners: list                 # [(module, attribute)] holding it
    shape: torch.Size            # whole
    spec: tuple                  # torch axes
    column_dim: Optional[int]    # the output axis a column module computes
    model_cut: bool              # gathered at use over "model"
    data_cut: bool               # cut over "data" (fsdp)
    master: Optional[nn.Parameter] = None
    compute_shape: Optional[torch.Size] = None

    @property
    def swapped(self) -> bool:
        """Is the tensor the modules compute with gathered at each use?"""
        return self.model_cut or self.data_cut

    @property
    def cut(self) -> bool:
        return self.swapped or self.column_dim is not None


def spec_axis(spec: tuple, axis: str) -> Optional[int]:
    """The torch axis that ``axis`` ("data" or "model") cuts in ``spec``
    (an entry may name both, as a tuple), or None."""
    return next((i for i, entry in enumerate(spec)
                 if entry == axis or (isinstance(entry, tuple) and axis in entry)), None)


def state_nbytes(params, optimizer=None) -> int:
    """Bytes of ``params`` and of their optimizer state tensors."""
    params = list(params)
    total = sum(p.numel() * p.element_size() for p in params)
    if optimizer is not None:
        for p in params:
            for v in optimizer.state.get(p, {}).values():
                if isinstance(v, torch.Tensor):
                    total += v.numel() * v.element_size()
    return total


class ShardedState:
    """The parameters of ``model`` kept by their placements on ``mesh``
    (``fsdp``: the data axis too); built on every rank at once, from whole
    weights that are the same on every rank (after ``broadcast_module``).
    The trainer builds its optimizer over ``masters()``; between
    ``reshard`` and ``unshard`` the modules hold the masters and the column
    forwards, each step runs inside ``gathered``, and the trainer calls
    this object after the backward to reduce the gradients. Where no leaf
    is cut (``cuts`` False) the masters are the modules' own parameters,
    ``reshard`` and ``unshard`` do nothing and a call all-reduces."""

    def __init__(self, model: nn.Module, mesh, fsdp: bool, min_size: int = 1024,
                 min_dim: int = 64):
        self.model = model
        self.placements = param_placements(model, mesh, fsdp, min_size, min_dim)
        run = mesh.distributed
        nccl = run and dist.get_backend() == "nccl"
        self.device = mesh.device
        self.data = _Axis(mesh.data_group, mesh.n_data, mesh.data_index, run, nccl)
        self.model_axis = _Axis(mesh.model_group, mesh.n_model, mesh.model_index, run, nccl)
        # a collective of every rank: each builds its state at once
        self._mask_group = dist.new_group(backend="gloo") if nccl else None
        params = param_owners(model)
        self.leaves: List[_Leaf] = []
        for name, p, owners in params:
            spec = self.placements[name]
            self.leaves.append(_Leaf(name, owners, p.shape, spec,
                                     self._column_dim(owners, spec),
                                     spec_axis(spec, MODEL_AXIS) is not None,
                                     spec_axis(spec, DATA_AXIS) is not None))
        self._columns = self._column_modules()
        self.cuts = any(leaf.cut for leaf in self.leaves)
        whole = {}
        with torch.no_grad():
            for leaf, (_, p, _) in zip(self.leaves, params):
                whole[id(p)] = leaf
                leaf.compute_shape = self._compute_shape(leaf)
                if not leaf.cut:
                    leaf.master = p
                    continue
                leaf.master = nn.Parameter(self._shard_of(leaf, p.detach()),
                                           requires_grad=p.requires_grad)
                # a piece, not a whole weight: what an endpoint's export refuses
                leaf.master.sharded_piece = True
        # the state_dict keys of each leaf (a tied parameter has several)
        self._keys = {k: whole[id(v)] for k, v in model.state_dict(keep_vars=True).items()
                      if id(v) in whole}
        self._computes: Dict[_Leaf, torch.Tensor] = {}
        self._present = None        # the last eager call's mask, which a capture reuses
        self._buffers = {}
        self.bytes_reduced = 0      # of the last call
        self.columns_on = False
        self.active = False         # do the modules hold the masters?

    def masters(self) -> List[nn.Parameter]:
        """The tensors the optimizer steps, in ``named_parameters`` order."""
        return [leaf.master for leaf in self.leaves]

    # ------------------------------------------------------------ placement
    def _column_dim(self, owners, spec) -> Optional[int]:
        """The output axis of a column module's weight or bias cut over
        "model", else None."""
        cut = spec_axis(spec, MODEL_AXIS)
        if cut is None or len(owners) != 1:
            return None
        module, attr = owners[0]
        out = _COLUMN_FORWARDS.get(type(module).forward)
        if (out is None or attr not in ("weight", "bias") or getattr(module, "groups", 1) != 1
                or getattr(module, "padding_mode", "zeros") != "zeros"):
            return None
        axis = out if attr == "weight" else 0
        return axis if cut == axis else None

    def _column_modules(self):
        """The modules that compute their own columns: every parameter of
        theirs cut over "model" on its output axis. A module with one
        parameter that is not has its leaves gathered at use instead."""
        by_module = {}
        for leaf in self.leaves:
            module, _ = leaf.owners[0]
            if leaf.column_dim is not None or leaf.model_cut:
                by_module.setdefault(id(module), (module, []))[1].append(leaf)
        columns = []
        for module, leaves in by_module.values():
            whole = [p for p in module._parameters.values() if p is not None]
            if (len(leaves) == len(whole)
                    and all(leaf.column_dim is not None for leaf in leaves)):
                for leaf in leaves:
                    leaf.model_cut = False
                columns.append(module)
            else:
                for leaf in leaves:
                    leaf.column_dim = None
        return columns

    def _compute_shape(self, leaf: _Leaf) -> torch.Size:
        shape = list(leaf.shape)
        if leaf.column_dim is not None:
            shape[leaf.column_dim] //= self.model_axis.size
        return torch.Size(shape)

    def place(self, leaf: _Leaf, data_index: Optional[int] = None,
              model_index: Optional[int] = None) -> tuple:
        """``(columns, flat)``: where the master of the rank at ``data_index``
        x ``model_index`` (default: this rank) lies in ``leaf``'s whole
        tensor. ``columns`` is its ``(start, stop)`` on ``leaf.column_dim``,
        ``flat`` its ``(start, stop)`` in the flattened column block: its
        piece of the model axis, then of the data axis. None where it keeps
        all of it."""
        di = self.data.index if data_index is None else data_index
        mi = self.model_axis.index if model_index is None else model_index
        columns = None
        if leaf.column_dim is not None:
            width = leaf.shape[leaf.column_dim] // self.model_axis.size
            columns = (mi * width, (mi + 1) * width)
        if not leaf.swapped:
            return columns, None
        start, n = 0, leaf.compute_shape.numel()
        for cut, axis, index in ((leaf.model_cut, self.model_axis, mi),
                                 (leaf.data_cut, self.data, di)):
            if cut:
                n //= axis.size
                start += index * n
        return columns, (start, start + n)

    def pieces(self, leaf: _Leaf) -> list:
        """``[(rank, columns, flat)]``: one rank for each distinct master of
        ``leaf`` over the mesh, the lowest that holds it (a whole leaf:
        rank 0; a leaf cut over one axis only: index 0 of the other)."""
        out = []
        for rank in range(self.data.size * self.model_axis.size):
            di, mi = divmod(rank, self.model_axis.size)
            if (di and not leaf.data_cut) or (
                    mi and not (leaf.model_cut or leaf.column_dim is not None)):
                continue
            out.append((rank, *self.place(leaf, di, mi)))
        return out

    def _shard_of(self, leaf: _Leaf, whole: torch.Tensor) -> torch.Tensor:
        """This rank's master of ``whole`` (the leaf's whole tensor): its
        columns, then its piece of the model axis and of the data axis, as
        a new tensor."""
        columns, flat = self.place(leaf)
        x = whole
        if columns is not None:
            x = x.narrow(leaf.column_dim, columns[0], columns[1] - columns[0])
        if flat is None:
            return x.contiguous().clone()
        return x.reshape(-1)[flat[0]:flat[1]].clone()

    # -------------------------------------------------------------- install
    def _set(self, leaf: _Leaf, tensor):
        for module, attr in leaf.owners:
            module._parameters[attr] = tensor

    def _install(self):
        """The masters in the modules, the column forwards on."""
        for leaf in self.leaves:
            self._set(leaf, leaf.master)
        for module in self._columns:
            module.forward = column_forward(module, self.model_axis, self)
        self.columns_on = self.active = True

    def unshard(self):
        """The live weights gathered whole (a collective of every rank) back
        in the modules, as plain parameters, and the plain forwards. The
        optimizer keeps the masters."""
        if not self.active:
            return
        whole = self.whole_state_dict()
        for leaf in self.leaves:
            if leaf.cut:   # an uncut leaf's master is the module's own parameter
                self._set(leaf, nn.Parameter(whole[leaf.name],
                                             requires_grad=leaf.master.requires_grad))
        for module in self._columns:
            del module.forward
        self.columns_on = self.active = False

    def reshard(self):
        """The modules' whole weights (the same on every rank) cut into the
        masters, and the masters and column forwards put in their place."""
        if not self.cuts:
            return
        with torch.no_grad():
            for leaf in self.leaves:
                module, attr = leaf.owners[0]
                whole = module._parameters[attr]
                if leaf.cut:
                    leaf.master.copy_(self._shard_of(leaf, whole.detach()))
                    leaf.master.requires_grad_(whole.requires_grad)
        self._install()

    # --------------------------------------------------------------- gather
    def _to_compute(self, tensors: dict) -> dict:
        """``{leaf: tensor in its master's layout}`` -> ``{leaf: the tensor
        the modules compute with}``: the data axis's pieces gathered, then
        the model axis's (a collective of every rank)."""
        flat = {leaf: t.reshape(-1) for leaf, t in tensors.items()}
        for cut, axis in (("data_cut", self.data), ("model_cut", self.model_axis)):
            leaves = [leaf for leaf in flat if getattr(leaf, cut)]
            for group in _flat_by_dtype(leaves, flat.get).values():
                sizes = [flat[leaf].numel() for leaf in group]
                src = torch.cat([flat[leaf] for leaf in group])
                out = src.new_empty(axis.size * src.numel())
                axis.all_gather(out, src)
                rows = out.view(axis.size, -1)
                start = 0
                for leaf, size in zip(group, sizes):
                    flat[leaf] = rows[:, start:start + size].reshape(-1)
                    start += size
        return {leaf: t.view(leaf.compute_shape) for leaf, t in flat.items()}

    def _columns_whole(self, tensors: dict) -> dict:
        """Column tensors gathered whole over the model axis (a collective
        of every rank); the others as they are."""
        out = dict(tensors)
        leaves = [leaf for leaf in tensors if leaf.column_dim is not None]
        k = self.model_axis.size
        for group in _flat_by_dtype(leaves, tensors.get).values():
            sizes = [tensors[leaf].numel() for leaf in group]
            src = torch.cat([tensors[leaf].reshape(-1) for leaf in group])
            gathered = src.new_empty(k * src.numel())
            self.model_axis.all_gather(gathered, src)
            rows = gathered.view(k, -1)
            start = 0
            for leaf, size in zip(group, sizes):
                piece = rows[:, start:start + size].reshape(k, *leaf.compute_shape)
                out[leaf] = piece.movedim(0, leaf.column_dim).reshape(leaf.shape)
                start += size
        return out

    def whole_of(self, tensors: dict) -> dict:
        """``{leaf: tensor in its master's layout}`` -> ``{leaf: whole
        tensor}`` (a collective of every rank)."""
        return self._columns_whole(self._to_compute(tensors))

    @contextlib.contextmanager
    def gathered(self, grad: bool = True):
        """Inside the block the modules compute with the cut leaves'
        tensors, all-gathered from the masters now (requiring grad where
        ``grad`` and the master does, for the reducer to read after the
        backward); the masters back on exit."""
        with torch.no_grad():
            computes = self._to_compute({leaf: leaf.master.detach()
                                         for leaf in self.leaves if leaf.swapped})
        for leaf, tensor in computes.items():
            if grad and leaf.master.requires_grad:
                tensor.requires_grad_()
            self._set(leaf, tensor)
        if grad:
            self._computes = computes
        try:
            yield
        finally:
            for leaf in computes:
                self._set(leaf, leaf.master)

    # --------------------------------------------------------------- reduce
    def _own_piece(self, leaf: _Leaf, grad: torch.Tensor, rows: int) -> torch.Tensor:
        """The gradient in the master's layout before the data axis, as
        ``rows`` rows (one a data rank for a scatter): a leaf cut over
        "model" keeps this rank's piece (the whole gradient is the same on
        every model rank)."""
        if not leaf.model_cut:
            return grad.reshape(rows, -1)
        flat = grad.reshape(-1)
        n = flat.numel() // self.model_axis.size
        return flat[self.model_axis.index * n:(self.model_axis.index + 1) * n].view(rows, -1)

    def _buffer(self, kind, dtype, group, size):
        key = (kind, dtype)
        ids = tuple(id(leaf) for leaf in group)
        if self._buffers.get(key, (None,))[0] != ids:
            self._buffers[key] = (ids, torch.empty(size, dtype=dtype, device=self.device))
        return self._buffers[key][1]

    def __call__(self):
        """The masters' gradients from this step's: reduce-scattered over
        "data" for the leaves cut over it, all-reduced over "data" for the
        others. A gradient None on every rank stays None."""
        grads = [(self._computes[leaf] if leaf.swapped else leaf.master).grad
                 for leaf in self.leaves]
        if capturing(self.device):
            if self._present is None:
                raise RuntimeError("ShardedState: a CUDA graph captured the gradient "
                                   "reduction before any eager step took its presence mask")
            present = self._present
        else:
            mask = torch.tensor([g is not None for g in grads], dtype=torch.uint8)
            if self.data.run:
                dist.all_reduce(mask, op=dist.ReduceOp.MAX, group=self._mask_group)
            present = self._present = [bool(f) for f in mask.tolist()]
        grad_of = {leaf: g for leaf, g in zip(self.leaves, grads)}
        self.bytes_reduced = 0
        n = self.data.size
        with torch.no_grad():
            for scatter in (True, False):
                leaves = [leaf for leaf, flag in zip(self.leaves, present)
                          if flag and leaf.data_cut == scatter]
                for group in _flat_by_dtype(leaves, lambda leaf: leaf.master).values():
                    sizes = [leaf.master.numel() for leaf in group]
                    dtype = group[0].master.dtype
                    out = self._buffer(scatter, dtype, group, sum(sizes))
                    views = [v.view_as(leaf.master) for v, leaf in zip(out.split(sizes), group)]
                    if scatter:
                        inp = torch.empty(n * out.numel(), dtype=dtype, device=self.device)
                        rows = inp.view(n, -1)
                        # each leaf's columns of every data rank's row, one copy kernel
                        torch.cat([self._own_piece(leaf, grad_of[leaf], n)
                                   if grad_of[leaf] is not None else rows.new_zeros(n, size)
                                   for leaf, size in zip(group, sizes)], dim=1, out=rows)
                        self.data.reduce_scatter(out, inp)
                    else:
                        inp = out
                        have = [(view, leaf) for view, leaf in zip(views, group)
                                if grad_of[leaf] is not None]
                        if len(have) < len(group):
                            out.zero_()
                        if have:
                            torch._foreach_copy_(
                                [view for view, _ in have],
                                [self._own_piece(leaf, grad_of[leaf], 1).view_as(view)
                                 if leaf.model_cut else grad_of[leaf] for view, leaf in have])
                        self.data.all_reduce(out)
                    self.bytes_reduced += inp.numel() * inp.element_size()
                    for leaf, view in zip(group, views):
                        leaf.master.grad = view
        self._computes = {}

    # ------------------------------------------------- whole state and back
    def whole_state_dict(self) -> dict:
        """The model's ``state_dict`` as a replicated run holds it: whole
        weights under the same keys, buffers as they are (with the masters
        in: a collective of every rank)."""
        if not self.active:
            return {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        whole = self.whole_of({leaf: leaf.master.detach() for leaf in self.leaves})
        out = {}
        for key, value in self.model.state_dict().items():
            leaf = self._keys.get(key)
            out[key] = (value.detach().clone() if leaf is None
                        else whole[leaf] if leaf.cut else whole[leaf].clone())
        return out

    def load_leaf(self, leaf: _Leaf, whole: torch.Tensor):
        """``leaf``'s whole weights into this rank's state, with no
        collective: its master cut from them and, where the modules hold
        whole weights (outside ``reshard`` ... ``unshard``), the module's
        parameter too."""
        with torch.no_grad():
            if leaf.cut:
                leaf.master.copy_(self._shard_of(leaf, whole.to(self.device, leaf.master.dtype)))
            if not (leaf.cut and self.active):
                module, attr = leaf.owners[0]
                param = module._parameters[attr]
                param.copy_(whole.to(param.device, param.dtype))

    def buffers(self) -> dict:
        """The model's ``state_dict`` entries that are no parameter's."""
        return {k: v for k, v in self.model.state_dict().items() if k not in self._keys}

    def _load_buffers(self, state_dict: dict):
        for key, value in self.model.state_dict(keep_vars=True).items():
            if key not in self._keys and key in state_dict:
                value.copy_(state_dict[key])

    def load_whole(self, state_dict: dict):
        """Load whole weights (a replicated run's ``state_dict``, the same
        on every rank) into the masters and buffers: no collective."""
        rest = {}
        for key, value in state_dict.items():
            leaf = self._keys.get(key)
            rest[key] = value if leaf is None else self._shard_of(
                leaf, value.to(self.device, leaf.master.dtype))
        self.model.load_state_dict(rest)

    @contextlib.contextmanager
    def whole_weights(self, state_dict: dict):
        """Inside the block the modules compute alone with the whole
        weights of ``state_dict`` (``whole_state_dict``'s keys) and the plain
        forwards: no collective (the kept weights' prediction grids, on rank
        0 only). The masters, buffers and column forwards are back on exit."""
        live = {k: v.detach().clone() for k, v in self.model.state_dict().items()
                if k not in self._keys}
        for leaf in self.leaves:
            self._set(leaf, state_dict[leaf.name].to(self.device))
        self._load_buffers(state_dict)
        self.columns_on = False
        try:
            yield
        finally:
            self.columns_on = True
            for leaf in self.leaves:
                self._set(leaf, leaf.master)
            self._load_buffers(live)

    def _optimizer_leaves(self, optimizer):
        leaf_of = {id(leaf.master): leaf for leaf in self.leaves}
        params = [p for group in optimizer.param_groups for p in group["params"]]
        return [leaf_of.get(id(p)) for p in params]

    def optimizer_state_whole(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with each cut leaf's state tensors
        whole, as a replicated run's optimizer holds them (a collective of
        every rank)."""
        sd = optimizer.state_dict()
        state = {i: dict(s) for i, s in sd["state"].items()}
        per_key = {}
        for i, leaf in enumerate(self._optimizer_leaves(optimizer)):
            if leaf is None or not leaf.cut:
                continue
            for key, value in state.get(i, {}).items():
                if isinstance(value, torch.Tensor) and value.shape == leaf.master.shape:
                    per_key.setdefault(key, {})[leaf] = (i, value)
        for key in sorted(per_key):
            items = per_key[key]
            whole = self.whole_of({leaf: v for leaf, (_, v) in items.items()})
            for leaf, (i, _) in items.items():
                state[i][key] = whole[leaf]
        return {**sd, "state": state}

    def load_optimizer_whole(self, optimizer, state_dict: dict):
        """Load a replicated run's optimizer state (the same on every rank):
        each cut leaf's whole state tensors cut into its master's layout."""
        state = {}
        leaves = self._optimizer_leaves(optimizer)
        for i, entry in state_dict["state"].items():
            leaf = leaves[int(i)]
            state[i] = {k: (self._shard_of(leaf, v.to(self.device)) if leaf is not None
                            and leaf.cut and isinstance(v, torch.Tensor)
                            and v.shape == leaf.shape else v)
                        for k, v in entry.items()}
        optimizer.load_state_dict({**state_dict, "state": state})

    def nbytes(self, optimizer=None) -> dict:
        """This rank's bytes at rest: every parameter and its optimizer
        state, and those of the cut leaves alone."""
        cut = [leaf.master for leaf in self.leaves if leaf.cut]
        return {"params_and_optimizer": state_nbytes(
                    [leaf.master for leaf in self.leaves], optimizer),
                "cut_params_and_optimizer": state_nbytes(cut, optimizer)}
