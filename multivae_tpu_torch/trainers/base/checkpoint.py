"""Sharded, asynchronous checkpoints of the train state: the port's
``checkpoint_backend="orbax"`` and ``async_checkpointing`` (counterpart of
``_orbax_save_state`` / ``_orbax_restore_state`` in
``multivae_tpu/trainers/base/base_trainer.py``).

The value names the JAX feature, not orbax's format: these are torch files
and a JSON index, which the JAX package does not read, and the port reads
no orbax checkpoint. ``checkpoint_epoch_<n>/train_state/`` holds:

- ``rank_<r>.pt`` for every rank r of the saving group: ``{leaf: {"param":
  piece, <optimizer state key>: piece, ...}}`` for the pieces r writes. A
  piece is a master as ``ShardedState._shard_of`` cuts it (``place``): a
  column layer's output columns on its model rank, then a flat range of the
  flattened column block where the leaf is cut over "model" or "data". A
  piece that several ranks hold alike (a whole leaf, a leaf not cut over one
  of the axes) is written once, by the lowest of them, as orbax writes one
  copy of a replicated shard (``ShardedState.pieces``).
- ``common.pt`` (rank 0): the optimizer's state entries that are not pieces
  (step counts), its param groups (by leaf name), the model's buffers and
  the training generator's state.
- ``index.json`` (rank 0): the saving mesh and, for each leaf, its whole
  shape, column axis, the optimizer keys that are pieces and each piece's
  rank, column range and flat range.

``Checkpointer.save`` copies this rank's tensors into pinned host buffers
(kept for the next save) and waits for the copy, the JAX "device->host
copy": a CUDA graph's next replay, which writes the masters and moments in
place, cannot reach a file. A background thread, one per trainer, then
writes and fsyncs the files into ``train_state.tmp``. ``wait`` joins it and
meets the other ranks (an error of any rank's writer raises on every rank),
and rank 0 renames the folder to ``train_state``: the commit. ``restore``
builds this rank's masters and optimizer state for its own layout, whatever
the saving one: each leaf assembled whole on the host from the pieces,
one leaf at a time (the modules hold whole weights outside ``train``), and
its optimizer state from the pieces that overlap this rank's master; the
files are read through ``torch.load(mmap=True)``, which touches only the
bytes read. No collective.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import time

import torch
import torch.distributed as dist

from ...parallel.state import ShardedState

STATE_DIR = "train_state"
TMP_SUFFIX = ".tmp"
INDEX, COMMON = "index.json", "common.pt"
FORMAT = "multivae_tpu_torch sharded train state"


def rank_file(rank: int) -> str:
    return f"rank_{rank}.pt"


def _overlaps(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def _may_overlap(piece: dict, column_dim, want) -> bool:
    """May the saved ``piece`` (of a leaf with ``column_dim``) hold any
    element of ``want`` = ``(column_dim, columns, flat)``? False only where
    the two are disjoint for sure."""
    want_dim, columns, flat = want
    if piece["columns"] is not None and columns is not None and column_dim == want_dim:
        if not _overlaps(piece["columns"], columns):
            return False
        if tuple(piece["columns"]) != tuple(columns):
            return True
    elif piece["columns"] is not None or columns is not None:
        return True
    return piece["flat"] is None or flat is None or _overlaps(piece["flat"], flat)


class Checkpointer:
    """One trainer's sharded checkpoints: ``save`` on every rank, ``wait``
    (a collective where a save is pending), ``restore``."""

    def __init__(self, mesh, barrier):
        self.mesh, self._barrier = mesh, barrier
        self._executor = None
        self._pending = None
        self._host = {}
        # the last save's seconds to host memory, to its files written (in
        # the background), to its commit (at the wait), and the bytes this
        # rank wrote
        self.last = {}

    # ----------------------------------------------------------------- save
    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def save(self, path: str, layout: ShardedState, optimizer, generator_state: torch.Tensor,
             fsdp: bool):
        """Write this rank's pieces of the train state to ``path`` (rank 0
        also the index and the common state), in the background; returns
        once the tensors are in host memory. A collective of every rank."""
        self.wait()
        t0 = time.perf_counter()
        rank = self.mesh.rank
        leaves = layout._optimizer_leaves(optimizer)
        sd = optimizer.state_dict()
        state = {leaves[i].name: entry for i, entry in sd["state"].items()}
        pieces, rest, index = {}, {}, []
        for leaf in layout.leaves:
            entry = state.get(leaf.name, {})
            keys = sorted(k for k, v in entry.items() if isinstance(v, torch.Tensor)
                          and v.dim() and v.shape == leaf.master.shape)
            rest[leaf.name] = {k: v for k, v in entry.items() if k not in keys}
            writers = layout.pieces(leaf)
            if any(r == rank for r, _, _ in writers):
                pieces[leaf.name] = {"param": leaf.master, **{k: entry[k] for k in keys}}
            index.append({"name": leaf.name, "shape": list(leaf.shape),
                          "column_dim": leaf.column_dim, "state_keys": keys,
                          "pieces": [{"rank": r, "columns": c, "flat": f}
                                     for r, c, f in writers]})
        files = {rank_file(rank): {name: {k: self._to_host((name, k), v) for k, v in d.items()}
                                   for name, d in pieces.items()}}
        if rank == 0:
            groups = [{**{k: (self._to_host(("group", i, k), v)
                              if isinstance(v, torch.Tensor) else v)
                          for k, v in g.items()},
                       "params": [leaves[j].name for j in g["params"]]}
                      for i, g in enumerate(sd["param_groups"])]
            files[COMMON] = {
                "state": {name: {k: (self._to_host((name, k), v)
                                     if isinstance(v, torch.Tensor) else v)
                                 for k, v in entry.items()}
                          for name, entry in rest.items() if entry},
                "param_groups": groups,
                "buffers": {k: self._to_host(("buffer", k), v)
                            for k, v in layout.buffers().items()},
                "generator": generator_state.clone()}
            files[INDEX] = {"format": FORMAT, "world_size": self.mesh.world_size,
                            "n_data": self.mesh.n_data, "n_model": self.mesh.n_model,
                            "fsdp": fsdp, "leaves": index}
        if layout.device.type == "cuda":
            # the copies done: the next step may write the masters in place
            torch.cuda.current_stream(layout.device).synchronize()
        self.last = {"copy_s": time.perf_counter() - t0}
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint-writer")
        tmp = path + TMP_SUFFIX
        self._pending = (self._executor.submit(_write, tmp, files), tmp, path, t0)

    def wait(self):
        """Wait for the pending save, if any, to be committed: this rank's
        writer joined, every rank met (each learns whether another's writer
        failed, and every rank raises then), rank 0 renames the folder, and
        every rank meets again. A collective of every rank where a save is
        pending."""
        if self._pending is None:
            return
        future, tmp, path, t0 = self._pending
        self._pending = None
        error = future.exception()
        failed = torch.zeros(self.mesh.world_size, dtype=torch.int32)
        failed[self.mesh.rank] = error is not None
        if self.mesh.distributed:
            nccl = dist.get_backend() == "nccl"
            flags = failed.to(self.mesh.device) if nccl else failed
            dist.all_reduce(flags)
            failed = flags.cpu()
        if error is not None:
            raise RuntimeError(f"the checkpoint writer of rank {self.mesh.rank} failed on "
                               f"{tmp}: {error!r}") from error
        if failed.any():
            ranks = [r for r, f in enumerate(failed.tolist()) if f]
            raise RuntimeError(f"the checkpoint writer of rank(s) {ranks} failed on {tmp}: "
                               "their error is in their own processes")
        if self.mesh.is_main_process:
            if os.path.exists(path):   # a run before this one's, in the same folder
                shutil.rmtree(path)
            os.replace(tmp, path)
            _fsync_dir(os.path.dirname(path))
        self._barrier()
        nbytes, written = future.result()
        self.last.update(written_s=written - t0, commit_s=time.perf_counter() - t0,
                         bytes=nbytes)

    def close(self):
        """Commit the pending save and stop the writer thread."""
        self.wait()
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    # -------------------------------------------------------------- restore
    @staticmethod
    def restore(path: str, layout: ShardedState, optimizer) -> torch.Tensor:
        """Load the committed train state at ``path`` into ``layout``'s
        masters (and the modules' whole weights where they hold them), its
        buffers and ``optimizer``, for this rank's layout; returns the
        training generator's state."""
        _check_committed(path)
        with open(os.path.join(path, INDEX)) as f:
            index = json.load(f)
        if index.get("format") != FORMAT:
            raise ValueError(f"{path}/{INDEX} is not an index of {FORMAT!r}")
        names = [rank_file(r) for r in range(index["world_size"])] + [COMMON]
        missing = [n for n in names if not os.path.exists(os.path.join(path, n))]
        if missing:
            raise FileNotFoundError(
                f"{path} is missing {missing}: the checkpoint of {index['world_size']} ranks "
                "is incomplete")
        files = [torch.load(os.path.join(path, n), mmap=True, weights_only=True,
                            map_location="cpu") for n in names]
        common = files.pop()
        saved = {leaf["name"]: leaf for leaf in index["leaves"]}
        ours = [leaf.name for leaf in layout.leaves]
        if set(saved) != set(ours):
            raise ValueError(f"{path} holds the leaves {sorted(set(saved) - set(ours))} that "
                             f"this model lacks, and lacks {sorted(set(ours) - set(saved))}")
        device = layout.device
        position = {id(leaf): i for i, leaf in enumerate(layout._optimizer_leaves(optimizer))}
        state = {}
        for leaf in layout.leaves:
            entry = saved[leaf.name]
            if list(entry["shape"]) != list(leaf.shape):
                raise ValueError(f"{path}: the leaf {leaf.name} is {entry['shape']} there, "
                                 f"{list(leaf.shape)} here")
            layout.load_leaf(leaf, _assemble(files, entry, "param"))
            want = (leaf.column_dim, *layout.place(leaf)) if leaf.cut else None
            values = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                      for k, v in common["state"].get(leaf.name, {}).items()}
            for key in entry["state_keys"]:
                values[key] = layout._shard_of(leaf, _assemble(files, entry, key, want)).to(device)
            if values:
                state[position[id(leaf)]] = values
        layout._load_buffers(common["buffers"])
        at = {leaf.name: position[id(leaf)] for leaf in layout.leaves}
        groups = [{**{k: v.to(device) if isinstance(v, torch.Tensor) else v
                      for k, v in g.items()}, "params": [at[n] for n in g["params"]]}
                  for g in common["param_groups"]]
        optimizer.load_state_dict({"state": state, "param_groups": groups})
        return common["generator"]


def _assemble(files: list, entry: dict, key: str, want=None) -> torch.Tensor:
    """The whole tensor ``key`` ("param" or an optimizer key) of the saved
    leaf ``entry`` on the host, from its pieces; with ``want`` (``(column
    dim, columns, flat)`` of a master) only the pieces that may overlap it
    are read, the rest left zero."""
    pieces = entry["pieces"]
    first = files[pieces[0]["rank"]][entry["name"]][key]
    whole = torch.zeros(entry["shape"], dtype=first.dtype)
    column_dim = entry["column_dim"]
    for piece in pieces:
        if want is not None and not _may_overlap(piece, column_dim, want):
            continue
        data = files[piece["rank"]][entry["name"]][key]
        target = whole
        if piece["columns"] is not None:
            start, stop = piece["columns"]
            target = whole.narrow(column_dim, start, stop - start)
        if piece["flat"] is None:
            target.copy_(data.view(target.shape))
        elif target.is_contiguous():
            target.view(-1)[piece["flat"][0]:piece["flat"][1]].copy_(data)
        else:   # a flat range of a column block: through a contiguous copy of it
            block = target.contiguous()
            block.view(-1)[piece["flat"][0]:piece["flat"][1]].copy_(data)
            target.copy_(block)
    return whole


def _check_committed(path: str):
    if not os.path.isdir(path):
        if os.path.exists(path + TMP_SUFFIX):
            raise RuntimeError(f"{path} was not committed: its save did not finish "
                               f"({os.path.basename(path + TMP_SUFFIX)} is there)")
        raise FileNotFoundError(f"no {STATE_DIR} at {path}")


def _write(folder: str, files: dict) -> tuple:
    """Write ``files`` (name -> object: JSON for ``.json``, else
    ``torch.save``) into ``folder``, each fsynced; (the bytes written, the
    ``perf_counter`` when done)."""
    os.makedirs(folder, exist_ok=True)
    total = 0
    for name, obj in files.items():
        path = os.path.join(folder, name)
        with open(path, "wb") as f:
            if name.endswith(".json"):
                f.write(json.dumps(obj, indent=1).encode())
            else:
                torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        total += os.path.getsize(path)
    return total, time.perf_counter()


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def is_sharded(checkpoint_dir: str) -> bool:
    """Does ``checkpoint_dir`` hold a sharded train state, committed or
    not?"""
    path = os.path.join(checkpoint_dir, STATE_DIR)
    return os.path.isdir(path) or os.path.exists(path + TMP_SUFFIX)
