"""A step's global batch as one process's loss sees it.

Under data parallelism each process computes the loss of its own rows. For
N processes to give what one process gives on the whole batch (the JAX
package's semantics, where the number of devices changes nothing), every
value a loss returns is this process's share of the global batch's value,
and the trainer sums the shares: the gradients once a step, the epoch sums
once an epoch. A model's loss asks its ``data_shard`` (``NO_SHARD`` outside
a data-parallel step, where every method is the identity) for:

- ``total(x)``: a count of the global batch (the weights' sum that
  normalizes a mean loss), summed over the processes;
- ``mean(x)``: this process's share of a per-row mean over the global
  batch's rows;
- ``global_mean(x)``: the mean itself, the same on every process and
  differentiable (a batch statistic such as Nexus's adapted top-decoder
  scale);
- ``share(x)``: this process's share of a value every process computes
  alike (an annealing factor logged as a metric);
- ``draw(hook, shape, generator, axis)``: a draw of the global batch's shape
  (the batch axis ``axis`` widened N times) of which this process keeps its
  own rows, so that the draws do not depend on the number of processes and
  the generators, seeded alike, stay in step;
- ``spread`` / ``own``: a tensor of this process's rows placed in (taken
  from) one of the global batch's rows, for draws that read per-row
  inputs;
- ``rows(n)``: the global positions of this process's rows;
- ``gather(t)``: every process's ``t`` in rank order (the evaluators'
  embeddings and latents), bit for bit.

``sum_exact`` all-reduces tensors that are nonzero on one process at most
(each entry), bit for bit: ``gather`` and the row-sharded device cache's
exchange.

This process holds rows ``[rank * b, (rank + 1) * b)`` of the global batch
of ``world * b`` rows. On a (data, model) mesh ``rank`` and ``world`` are
the data axis's and ``group`` its process group: the ranks of one model
group hold the same rows, draw the same noise and take no part in each
other's sums. A draw or a tensor whose batch axis holds ``blocks``
consecutive blocks of the rows (MHVAE's subsets) keeps its share of each.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def sum_exact(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The SUM over the group of ``tensors``, each entry of which is nonzero
    on one rank at most (every other rank holds exact zeros there), as new
    tensors: one ``all_reduce`` of their bytes as uint8, in which no sum
    carries, so each entry comes back as its rank's value bit for bit (a
    float's -0.0 and NaN payloads too). The JAX package's row-sharded cache
    sums the same exact zeros in the values' own dtype."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat) if len(flat) > 1 else flat[0].clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    parts = buf.split([f.numel() for f in flat])
    return [p.view(t.dtype).view(t.shape) for p, t in zip(parts, tensors)]


class DataShard:
    """Process ``rank`` of ``world`` in a data-parallel step; ``distributed``
    says whether the collectives run (a group of one process runs them
    too), over ``group`` (None: the default group)."""

    def __init__(self, rank: int = 0, world: int = 1, distributed: bool = False,
                 group=None):
        self.rank, self.world, self.distributed = rank, world, distributed
        self.group = group

    # ------------------------------------------------------------- reductions
    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a quantity of the data: no gradient) summed over the
        processes, in at least float32 and given back in ``x``'s dtype: a
        bf16 count (a mixed-precision step's weight sum) is the one-process
        sum's, rounded once."""
        if not self.distributed:
            return x
        total = x.detach().to(torch.promote_types(x.dtype, torch.float32), copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total.to(x.dtype)

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every entry of ``x`` over the global batch, with its
        gradient: the backward sums the cotangents over the processes."""
        if not self.distributed:
            return x.mean()
        import torch.distributed.nn.functional as dist_fn

        group = {} if self.group is None else {"group": self.group}
        return dist_fn.all_reduce(x.sum(), op=dist.ReduceOp.SUM, **group) / (
            x.numel() * self.world)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This process's share of the mean of ``x`` over the global batch's
        rows (``x`` holds one value a local row)."""
        if self.world == 1:
            return x.mean()
        return x.sum() / (x.numel() * self.world)

    def share(self, x):
        """This process's share of ``x``, which every process computes alike."""
        return x if self.world == 1 else x / self.world

    # ------------------------------------------------------------------ rows
    def rows(self, n: int, device=None) -> torch.Tensor:
        """The global positions of this process's ``n`` rows."""
        return torch.arange(self.rank * n, (self.rank + 1) * n, device=device)

    def own(self, t: torch.Tensor, axis: int = 0, blocks: int = 1) -> torch.Tensor:
        """This process's rows of ``t``, whose ``axis`` holds the global
        batch's rows (in ``blocks`` consecutive blocks)."""
        if self.world == 1:
            return t
        axis = axis % t.dim()
        n = t.shape[axis] // (blocks * self.world)
        split = t.reshape(*t.shape[:axis], blocks, self.world * n, *t.shape[axis + 1:])
        mine = split.narrow(axis + 1, self.rank * n, n)
        return mine.reshape(*t.shape[:axis], blocks * n, *t.shape[axis + 1:])

    def spread(self, t: torch.Tensor, axis: int = 0, fill: float = 0.0) -> torch.Tensor:
        """``t`` (this process's rows on ``axis``) placed at its rows of a
        global-batch tensor filled with ``fill`` elsewhere."""
        if self.world == 1:
            return t
        axis = axis % t.dim()
        n = t.shape[axis]
        shape = list(t.shape)
        shape[axis] = n * self.world
        out = t.new_full(shape, fill)
        out.narrow(axis, self.rank * n, n).copy_(t)
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` (the same shape on each) concatenated on the
        first axis in rank order, the same on every process: an all-gather
        through ``sum_exact``, which takes only ``all_reduce`` (gloo has
        few collectives for CUDA tensors). ``t`` lives where the group's
        backend reads it (the card for NCCL)."""
        if not self.distributed:
            return t
        out = t.new_zeros((self.world, *t.shape))
        out[self.rank].copy_(t)
        return sum_exact([out], self.group)[0].reshape(self.world * t.shape[0], *t.shape[1:])

    def draw(self, hook, shape, generator=None, axis: int = -2, blocks: int = 1):
        """``hook(shape, generator)`` drawn at the global batch's shape (the
        batch axis ``axis`` widened to every process's rows), this process's
        rows kept."""
        if self.world == 1:
            return hook(shape, generator)
        shape = list(shape)
        axis = axis % len(shape)
        shape[axis] *= self.world
        return self.own(hook(tuple(shape), generator), axis, blocks)


NO_SHARD = DataShard()
