"""Epoch trainer (counterpart of the synchronous loop of
``multivae_tpu/trainers/base/base_trainer.py``), on one device or data
parallel over a process group, one process per card.

Per epoch: the ``prepare_train_step`` hook (the ``MultistageTrainer``'s
optimizer reset), the loader's seeded permutation, one optimizer step per
batch (its gradient accumulated over ``microbatch_steps`` chunks where
set), the epoch loss as the sum of the batches' ``loss_sum`` over the
dataset size, a NaN guard, the scheduler step, best-model tracking, the
prediction grids every ``steps_predict`` epochs, a checkpoint every
``steps_saving`` epochs, and the callbacks' events where the JAX loop
fires them. Up to the model's ``start_keep_best_epoch`` (0 unless the
model sets it, as MVAE's and JMVAE's warm-ups do) every epoch's weights
are kept; after it, those of the best eval loss (of the best train loss
with ``keep_best_on_train``), where an epoch without an eval set counts as
no better than the best so far, so the last warm-up epoch's weights stay.
At the end the kept weights (the live ones when none were kept) are saved
with the training config in
``<output_dir>/<model>_training_<time>/final_model``; ``best_model`` loads
them into the model.

Before training, one forward of the loss on the first train batch, under
``no_grad`` and with its own generator, checks that the data fits the
model (the JAX package traces the same call with ``eval_shape``).

Sampling noise comes from one ``torch.Generator`` on the device, seeded
with ``training_config.seed`` and advanced step after step; each eval pass
draws from a generator seeded with ``seed + 1000 + epoch``. A checkpoint
``checkpoint_epoch_<N>`` holds the kept weights (``model.pt`` through
``model.save``), the live ones (``live_params.pt``), the optimizer's state
(``optimizer.pt``), the scheduler's (``scheduler.json``), the training
generator's (``generator.pt``), ``training_config.json`` and
``info_checkpoint.json``: the JAX package's layout, with torch files
where it writes msgpack, and the generator's state where it re-derives
its noise from the step count. With ``checkpoint_backend="orbax"`` (JAX
``_orbax_save_state``) the live weights, the optimizer's and the
generator's states go instead to ``train_state/``, sharded: every rank
writes its own pieces (``checkpoint.py``), no gather, in the background
where ``async_checkpointing`` (the default) is on: the save returns once
the pieces are in host memory, and ``wait_for_checkpoint`` (before the
next save, before a resume and at the end of ``train()``) commits it. A
trainer built with ``checkpoint=`` goes on from epoch N + 1 as the
uninterrupted run would, from ``train_state/`` where the folder has one,
in its own layout whatever the saving one.

Batches reach the device in one of two ways. With ``cache_on_device``
the train and eval sets are uploaded at construction
(``data/device_cache.py``; the eval set gets what the train set leaves
of the budget), each epoch uploads its index plan, and each step gathers
its rows on the device; the train cache is also left on
``train_dataset._sampler_device_cache`` for the samplers' fit. Otherwise
(or where a cache falls back) a ``PrefetchLoader`` thread gathers the next
batches on the host and copies them ahead of the step. Both give the host
loader's batches, bit for bit. ``train(log_output_dir=...)`` also writes
the training parameters and each checkpoint's line to
``training_logs_<training dir>.log`` there.

With the cache and ``steps_per_execution`` N > 1 an epoch runs in chunks
of N steps and a remainder, the JAX trainer's ``lax.scan`` chunks: each
chunk reads its first plan row from a device scalar, gathers each step's
rows from the persistent plan (``data/device_cache.PlanBuffer``), runs the
steps and sums the loss and metrics into fixed device buffers. On CUDA a
chunk is a CUDA graph, captured once per length and replayed
(``graphs.py``; the optimizer is made capturable, its learning rate a
device tensor); on the CPU it runs eagerly. The per-step callbacks fire N
times after each chunk, as in the JAX trainer. The graphs are dropped and
captured again after an optimizer reset, a stage change and a resume.

``pipeline_epochs`` (the JAX default, on) defers each epoch's host side
(the loss fetch, NaN guard, best-model tracking, grids, checkpoint,
``on_epoch_end``, logging) by up to ``pipeline_depth`` epochs, so the host
queues the next epochs while the device works; the deferred epochs' sums
come back in one transfer and are finalized in order with the values of
the synchronous loop. The weights best-model tracking may keep wait in one
candidate copy on the device, which an epoch's end overwrites where that
epoch beats the best loss so far (``_track_best``): one copy of the
weights however deep the window. Checkpoint and prediction epochs, the epoch
before a ``prepare_train_step`` boundary (the ``MultistageTrainer``'s
``_prepare_boundaries``) and the last epoch finalize at once. A
deterministic scheduler steps when its epoch is queued. The synchronous
loop stays where the JAX trainer keeps it (``ReduceLROnPlateau``, a
subclass's ``train_step``/``eval_step``, an undeclared
``prepare_train_step``, a callback with its own ``on_epoch_end``) and
where an instance's hooks were replaced.

Data parallelism (``parallel/mesh.py``): where a ``torch.distributed``
group exists (opened from ``coordinator_address`` / ``num_processes`` /
``process_id``, by torchrun, or by the caller), each of its N processes
trains a replica of the model (rank 0's weights broadcast at
construction) on its ``per_device_train_batch_size`` columns of a global
batch N times that. The model's loss sees its part of the global batch
through ``model.data_shard`` (``parallel/shard.py``): its normalizers are
the global batch's and its draws the global batch's, this process's rows
kept, so every value it returns is this process's share of what one
process computes on the global batch. After each step's backward (after
the last microbatch chunk) the gradients are summed over the group in one
flat buffer; the epoch sums are summed once an epoch. So N processes give
the run of one process on the global batch, up to float32 summation
order. Only rank 0 logs, writes the prediction grids, the checkpoints, the
final model and the file log, and fires ``on_prediction_step``,
``on_save`` and ``on_save_checkpoint``; the other events fire on every
rank. The device caches follow the JAX layout rules over the group
(``data/device_cache.py``): replicated where a set fits one card's budget,
else row-sharded over the ranks, each step then gathering the global
batch's rows with one all-reduce. With ``steps_per_execution`` > 1 a chunk
runs the same collectives (the loss's normalizers, the sharded cache's
exchange, the gradient all-reduce, which reuses the presence mask of the
eager chunk before each capture); under NCCL the chunk's CUDA graph
captures them. Gloo collectives cannot be captured, so a gloo group on
CUDA refuses ``steps_per_execution`` > 1; on the CPU the chunks run
eagerly under gloo.

``fsdp`` and ``n_model_devices`` (JAX ``_state_sharding``): the
processes form a (data, model) mesh of ``n_devices`` x ``n_model_devices``
(adjacent ranks on the model axis); the loader, the loss's normalizers and
draws, the epoch sums and the sharded cache run over the data axis, and
the parameters are kept by ``combined_state_sharding``'s placements
(``parallel/state.py``): the masters of the leaves cut over "data" and
their optimizer state as this rank's piece, gathered inside each step
(``_gathered``) and their gradients reduce-scattered; the wide Linear and
convolution layers cut over "model" computing their own output columns.
The modules hold the masters inside ``train`` only (whole weights, plain,
before and after it); the keep-best state, the msgpack checkpoints and the
final model stay whole weights (collectives of every rank, then rank 0
writes), and the sharded checkpoints hold each rank's pieces. A graphed chunk under
NCCL captures the gathers, the reduce-scatter and the model axis's
collectives with the rest.

``mixed_precision`` (JAX ``loss_fn`` with ``_to_bf16``): each train step
runs the model's ``loss_function`` on bfloat16 copies of the float32
parameters (swapped in for the loss and its backward,
``mixed_precision.py``) and of the batch's float leaves (not autocast:
every op of the loss runs in bf16, as in the JAX mode; integer tokens
stay). The loss comes back in float32 and its backward reaches the
float32 master parameters through the casts, so the gradients, the
optimizer's state, the gradient all-reduce and the checkpoints stay
float32. Microbatch chunks cast each, and their gradients add up in
float32; a graphed chunk captures the casts, which read the parameters
the optimizer updates in place at each replay. The eval pass and the
sanity check's forward stay float32.

The JAX trainer's fused whole-epoch blocks (and the in-graph plateau
scheduler they carry) exist to amortize TPU launch costs and are not part
of the port. ``history`` holds each epoch's logged metrics.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import json
import logging
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ...data.batch import batch_from_arrays, floats_to
from ...data.device_cache import (
    PlanBuffer,
    ShardedDeviceDataCache,
    build_device_cache,
    cache_per_device_nbytes,
)
from ...data.loader import DataLoader
from ...data.prefetch import PrefetchLoader
from ...data.utils import adapt_shape, grid_to_image, make_grid, write_png
from ...models.base.base_ae_model import BaseMultiVAE
from ...models.base.base_model import BaseModel
from ...models.base.step import StepInfo
from ...ops.microbatch import microbatched_backward
from ...parallel.mesh import broadcast_module, get_data_mesh, maybe_init_distributed
from ...parallel.shard import DataShard
from ...parallel.state import ShardedState
from ...utils.device import resolve_device
from .base_trainer_config import BaseTrainerConfig
from .callbacks import (
    CallbackHandler,
    MetricConsolePrinterCallback,
    ProgressBarCallback,
    TrainingCallback,
)
from .checkpoint import STATE_DIR, Checkpointer, is_sharded
from .graphs import ChunkGraphs
from .mixed_precision import bf16_parameters
from .optim import make_capturable, make_optimizer, make_scheduler
from .utils import set_seed, update_dict

logger = logging.getLogger(__name__)


def _tensor_item(obj):
    """JSON of a 0-d tensor (a capturable optimizer's rate in a scheduler's
    state) as its number."""
    if isinstance(obj, torch.Tensor):
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


class BaseTrainer:
    """Epoch trainer on one device.

    Args:
        model: a BaseMultiVAE (or BaseModel); moved to ``device``.
        train_dataset / eval_dataset: MultimodalBaseDataset instances.
        training_config: BaseTrainerConfig.
        callbacks: list of TrainingCallback (a progress bar and a console
            printer are appended).
        checkpoint: a ``checkpoint_epoch_N`` folder to resume from.
        device: where training runs (default "cuda"; raises when CUDA is
            absent). Under a process group, "cuda" means this process's
            card, ``cuda:<local rank mod the visible cards>``.

    A model that defines ``reset_optimizer_epochs`` (TELBO, JNF) needs the
    ``MultistageTrainer`` and is refused here.
    """

    def __init__(self, model: BaseModel, train_dataset, eval_dataset=None,
                 training_config: Optional[BaseTrainerConfig] = None,
                 callbacks: Optional[List[TrainingCallback]] = None,
                 checkpoint: Optional[str] = None, device="cuda"):
        self.checktrainer(model)
        if training_config is None:
            training_config = BaseTrainerConfig()
        if training_config.output_dir is None:
            training_config.output_dir = "dummy_output_dir"
        cfg = training_config
        self.device = resolve_device(device)
        maybe_init_distributed(cfg.coordinator_address, cfg.num_processes,
                               cfg.process_id, device=self.device)
        self.mesh = get_data_mesh(cfg.n_devices, self.device, cfg.n_model_devices)
        self.device = self.mesh.device
        self.is_main_process = self.mesh.is_main_process
        # the data axis: the ranks of one model group take the same rows
        world, rank = self.mesh.n_data, self.mesh.data_index
        if self.mesh.distributed:
            self._check_data_parallel(cfg)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.training_config = training_config
        self.model_config = getattr(model, "model_config", None)

        set_seed(cfg.seed)
        self.train_loader = DataLoader(
            train_dataset, cfg.per_device_train_batch_size * world, shuffle=True,
            seed=cfg.seed, drop_last=cfg.drop_last, num_processes=world,
            process_index=rank, chunks=cfg.microbatch_steps)
        self.eval_loader = (
            DataLoader(eval_dataset, cfg.per_device_eval_batch_size * world,
                       shuffle=False, seed=cfg.seed, drop_last=cfg.drop_last,
                       num_processes=world, process_index=rank)
            if eval_dataset is not None else None)

        if cfg.microbatch_steps > 1:
            if not getattr(model, "loss_is_sum", False):
                raise AttributeError(
                    "microbatch_steps > 1 requires a SUM-reduction "
                    "objective (chunked gradient accumulation is only "
                    f"exact for batch-sum losses); {type(model).__name__} "
                    "does not declare loss_is_sum = True."
                )
            if self.train_loader.batch_size % cfg.microbatch_steps:
                raise AttributeError(
                    f"global train batch size {self.train_loader.batch_size} "
                    "is not divisible by microbatch_steps="
                    f"{cfg.microbatch_steps}."
                )
            if cfg.per_device_train_batch_size % cfg.microbatch_steps:
                raise AttributeError(
                    "per_device_train_batch_size "
                    f"{cfg.per_device_train_batch_size} is not divisible by "
                    f"microbatch_steps={cfg.microbatch_steps}: each process "
                    "takes its share of every chunk.")

        # data parallelism: the model's view of the global batch, rank 0's
        # weights on every rank and the state kept by its placements (with
        # neither fsdp nor a model axis, whole), whose call reduces the
        # gradients over the group
        self._shard = self._reducer = self._state = None
        if self.mesh.distributed:
            self._shard = DataShard(rank, world, distributed=True, group=self.mesh.data_group)
            broadcast_module(self.model)
        if self.mesh.distributed or cfg.fsdp or cfg.n_model_devices > 1:
            self._state = self._reducer = ShardedState(self.model, self.mesh, fsdp=cfg.fsdp)

        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # one generator for every eval pass, seeded anew each epoch, so that
        # the eval graphs can register it
        self._eval_generator = torch.Generator(device=self.device)

        self.trained_epochs = 0
        self.best_train_loss = math.inf
        self.best_eval_loss = math.inf
        self._best_state = None
        self._candidate = None   # the pipelined window's, see _track_best
        self.start_keep_best_epoch = getattr(model, "start_keep_best_epoch", 0)
        self.history = []
        self._file_logger = None
        self._checkpointer = None
        # the last checkpoint's seconds (``blocked_s``: the save's call; the
        # sharded one's ``copy_s`` to host, and once committed
        # ``written_s``, ``commit_s`` and this rank's ``bytes``)
        self.checkpoint_times = {}

        self._train_cache = self._eval_cache = None
        if cfg.cache_on_device:
            budget = int(cfg.device_cache_budget_gb * 1e9)
            layout = cfg.device_cache_layout
            self._train_cache = build_device_cache(train_dataset, self.device, budget,
                                                   layout=layout, mesh=self.mesh)
            if self._train_cache is not None and not isinstance(
                    self._train_cache, ShardedDeviceDataCache):
                # a sampler fitted on this dataset reuses the upload
                train_dataset._sampler_device_cache = self._train_cache
            if eval_dataset is not None:
                # the eval set has a budget of its own: what the train cache
                # leaves, all of it when the train set fell back
                used = (0 if self._train_cache is None
                        else cache_per_device_nbytes(self._train_cache))
                self._eval_cache = build_device_cache(eval_dataset, self.device,
                                                      max(budget - used, 0), layout=layout,
                                                      mesh=self.mesh)
        self._prefetch = {
            "train": PrefetchLoader(self.train_loader, self.device, depth=2),
            "eval": (PrefetchLoader(self.eval_loader, self.device, depth=2)
                     if self.eval_loader is not None else None)}
        self._plans = {which: PlanBuffer(loader, self.device, cache) for which, loader, cache in (
            ("train", self.train_loader, self._train_cache),
            ("eval", self.eval_loader, self._eval_cache)) if cache is not None}
        # the chunked path: its graphs, device inputs and sums
        self._graphs = {"train": ChunkGraphs(self.device, self.generator, "train"),
                        "eval": ChunkGraphs(self.device, self._eval_generator, "eval")}
        self._chunk_start = {w: torch.zeros((), dtype=torch.int64, device=self.device)
                             for w in self._plans}
        self._chunk_epoch = {w: torch.zeros((), dtype=torch.float32, device=self.device)
                             for w in self._plans}
        self._chunk_sums = {w: {} for w in self._plans}
        self._build_optimizer()

        self._run_model_sanity_check()

        if checkpoint is not None:
            self._resume_from_checkpoint(checkpoint)

        signature = [str(datetime.datetime.now())[:19]
                     .replace(" ", "_").replace(":", "-")]
        if self.mesh.distributed:   # rank 0's: one training dir for all
            torch.distributed.broadcast_object_list(signature, src=0)
        self.training_dir = os.path.join(
            cfg.output_dir,
            f"{getattr(model, 'model_name', type(model).__name__)}"
            f"_training_{signature[0]}")
        if self.is_main_process:
            os.makedirs(self.training_dir, exist_ok=True)

        callbacks = list(callbacks) if callbacks is not None else []
        callbacks.append(ProgressBarCallback())
        callbacks.append(MetricConsolePrinterCallback())
        self.callback_handler = CallbackHandler(callbacks, model)
        self.callback_handler.on_init_end(training_config)

    def checktrainer(self, model):
        """Refuse models that need multistage training."""
        if getattr(model, "reset_optimizer_epochs", None):
            raise AttributeError(
                f"The model {type(model).__name__} requires the "
                "MultistageTrainer for training (it defines "
                "reset_optimizer_epochs). Please use "
                "multivae_tpu_torch.trainers.MultistageTrainer instead of "
                "BaseTrainer.")

    def _check_data_parallel(self, cfg):
        """Refuse what a process group cannot run: graphed chunks over gloo
        on CUDA (a CUDA graph captures NCCL collectives only)."""
        if (cfg.steps_per_execution > 1 and self.device.type == "cuda"
                and self.mesh.backend == "gloo"):
            raise NotImplementedError(
                "steps_per_execution > 1 under a gloo process group on CUDA: the "
                "chunks' CUDA graphs capture NCCL collectives only (gloo goes "
                "through the host). Open the group with the NCCL backend, or use "
                "steps_per_execution=1.")

    def _run_model_sanity_check(self):
        """One forward of the loss on the first train batch. It runs under
        ``no_grad`` and draws from a generator of its own, so the training
        generator, and with it every later step's noise, stays put."""
        try:
            batch = next(iter(self.train_loader)).to(self.device)
            generator = torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad(), self._gathered(grad=False):
                self.model.loss_function(batch, StepInfo(), generator=generator)
        except Exception as e:
            raise ValueError(
                "Error when calling forward on a batch of the training "
                "dataset. Possible reasons: the data input doesn't match "
                "your model's architecture or the model config. Original "
                f"exception: {e}"
            ) from e

    def _build_optimizer(self):
        """The optimizer and scheduler of the config over the model's
        parameters; capturable where the steps run as CUDA graphs. Drops
        the graphs of the optimizer before."""
        cfg = self.training_config
        params = self._state.masters() if self._state is not None else self.model.parameters()
        self.optimizer = make_optimizer(cfg.optimizer_cls, params,
                                        cfg.learning_rate, cfg.optimizer_params)
        self.scheduler = make_scheduler(cfg.scheduler_cls, self.optimizer,
                                        cfg.scheduler_params)
        if self._graphed:
            make_capturable(self.optimizer)
        self._drop_graphs()

    @property
    def _sharded(self) -> bool:
        """Do the modules hold the masters of a ``ShardedState``?"""
        return self._state is not None and self._state.active

    def _gathered(self, grad: bool = True):
        """Where a step's loss (and backward) runs: with the cut leaves
        gathered under ``fsdp`` or a model axis."""
        if self._sharded:
            return self._state.gathered(grad)
        return contextlib.nullcontext()

    @property
    def _graphed(self) -> bool:
        """Do the train steps run as CUDA graphs?"""
        return (self.device.type == "cuda" and "train" in self._plans
                and self.training_config.steps_per_execution > 1)

    def _drop_graphs(self):
        """Forget the captured chunks (a new optimizer, a stage change, a
        resume): the next chunk runs eagerly and the ones after it are
        captured again. The gradients, which may live in a dropped graph's
        memory pool, go back to None."""
        for graphs in self._graphs.values():
            graphs.drop()
        if hasattr(self, "optimizer"):
            self.optimizer.zero_grad(set_to_none=True)

    def prepare_train_step(self, epoch, best_train_loss, best_eval_loss):
        """Hook for changes between epochs (the ``MultistageTrainer``'s
        optimizer reset); returns the best train and eval losses to go on
        with."""
        return best_train_loss, best_eval_loss

    def _prepare_boundaries(self):
        """The epochs at which ``prepare_train_step`` does real work: none
        for this class's hook, None (unknown) for a subclass's hook that
        does not declare them. The epoch before each finalizes at once."""
        if type(self).prepare_train_step is BaseTrainer.prepare_train_step:
            return set()
        return None

    # ------------------------------------------------------------- stepping
    def _train_loss(self, batch, info, generator):
        """The model's loss on ``batch`` in a train step: as it is, or under
        ``mixed_precision`` (inside ``_train_context``, on the bf16
        parameters) on the batch's float leaves in bfloat16, with the loss
        back in float32 (JAX ``loss_fn``)."""
        if not self.training_config.mixed_precision:
            return self.model.loss_function(batch, info, generator=generator)
        out = self.model.loss_function(floats_to(batch, torch.bfloat16), info,
                                       generator=generator)
        out["loss"] = out["loss"].float()
        return out

    def _train_context(self):
        """Where a train step's loss and backward run: under
        ``mixed_precision``, the model on bfloat16 copies of its parameters
        cast now from the live ones (kept nowhere)."""
        if self.training_config.mixed_precision:
            return bf16_parameters(self.model)
        return contextlib.nullcontext()

    def _epoch_batches(self, which: str):
        """The epoch's batches on the device: gathered from the device cache
        by the uploaded plan, or prefetched from the host loader."""
        cache = self._train_cache if which == "train" else self._eval_cache
        if cache is None:
            yield from self._prefetch[which]
            return
        plan = self._plans[which]
        idx, weights = plan.upload()
        for i in range(len(idx)):
            yield cache.gather(idx[i], weights[i], plan.columns)

    def _run_epoch(self, loader, epoch: int, generator, train: bool) -> dict:
        """The epoch's device sums, ``loss_sum`` first, then each metric."""
        which = "train" if train else "eval"
        if which in self._plans and self.training_config.steps_per_execution > 1:
            return self._run_chunked_epoch(which, loader, epoch, generator)
        n_batches = len(loader)
        dataset_size = len(loader.dataset)
        n_micro = self.training_config.microbatch_steps
        sums = {"loss_sum": torch.zeros((), device=self.device)}
        for batch_idx, batch in enumerate(self._epoch_batches(which)):
            # the eval pass leaves batch_ratio at 0, as the JAX trainer does
            info = StepInfo(epoch=epoch, batch_ratio=batch_idx / n_batches if train else 0.0,
                            dataset_size=dataset_size)
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                with self.model.sharded(self._shard), self._gathered():
                    out = microbatched_backward(
                        lambda chunk: self._train_loss(chunk, info, generator),
                        batch, n_micro, self._train_context)
                if self._reducer is not None:
                    self._reducer()
                self.optimizer.step()
                self.callback_handler.on_train_step_end(self.training_config)
            else:
                with self.model.sharded(self._shard), self._gathered(grad=False):
                    out = self.model.loss_function(batch, info, generator=generator)
                self.callback_handler.on_eval_step_end(self.training_config)
            sums["loss_sum"] += out["loss_sum"].detach()
            # in at least float32, as the chunks' sums (a bf16 step's metrics)
            update_dict(sums, {k: v.detach().to(torch.promote_types(v.dtype, torch.float32))
                               for k, v in out.get("metrics", {}).items()})
        return sums

    def _run_chunked_epoch(self, which: str, loader, epoch: int, generator) -> dict:
        """The epoch in chunks of ``steps_per_execution`` steps and a
        remainder (JAX ``_run_cached_train_epoch`` /
        ``_run_cached_eval_epoch``); the per-step callbacks fire after each
        chunk, once a step."""
        self._plans[which].upload()
        self._chunk_epoch[which].fill_(epoch)
        for acc in self._chunk_sums[which].values():
            acc.zero_()
        n_batches, chunk = len(loader), self.training_config.steps_per_execution
        event = (self.callback_handler.on_train_step_end if which == "train"
                 else self.callback_handler.on_eval_step_end)
        b = 0
        while b < n_batches:
            n = min(chunk, n_batches - b)
            self._chunk_start[which].fill_(b)
            self._graphs[which].run(
                n, lambda n=n: self._chunk(which, loader, n, generator),
                baked=self._baked_rates() if which == "train" else ())
            for _ in range(n):
                event(self.training_config)
            b += n
        return dict(self._chunk_sums[which])

    def _baked_rates(self) -> tuple:
        """The learning rates a graph holds as numbers (an optimizer without
        a capturable mode): a change means a new capture."""
        return tuple(g["lr"] for g in self.optimizer.param_groups
                     if not isinstance(g["lr"], torch.Tensor))

    def _chunk(self, which: str, loader, n: int, generator):
        """``n`` steps from the plan row in ``_chunk_start``, their loss and
        metrics added to ``_chunk_sums``: the body a CUDA graph captures.
        ``batch_ratio`` is computed in float32 on the device, as the JAX
        chunk does. Under a process group the steps run the eager loop's
        collectives, which an NCCL capture takes into the graph."""
        cache = self._train_cache if which == "train" else self._eval_cache
        plan = self._plans[which]
        rows = self._chunk_start[which] + torch.arange(n, device=self.device)
        idx, weights = plan.idx.index_select(0, rows), plan.weights.index_select(0, rows)
        train = which == "train"
        ratio = rows.to(torch.float32) / len(loader)
        sums = self._chunk_sums[which]
        for i in range(n):
            info = StepInfo(epoch=self._chunk_epoch[which],
                            batch_ratio=ratio[i] if train else 0.0,
                            dataset_size=len(loader.dataset))
            batch = cache.gather(idx[i], weights[i], plan.columns)
            if train:
                # as in the eager loop: under a capture, backward then
                # allocates each gradient from the graph's pool, where every
                # replay writes it again
                self.optimizer.zero_grad(set_to_none=True)
                with self.model.sharded(self._shard), self._gathered():
                    out = microbatched_backward(
                        lambda part: self._train_loss(part, info, generator),
                        batch, self.training_config.microbatch_steps, self._train_context)
                if self._reducer is not None:
                    self._reducer()
                self.optimizer.step()
            else:
                with self.model.sharded(self._shard), self._gathered(grad=False):
                    out = self.model.loss_function(batch, info, generator=generator)
            values = {"loss_sum": out["loss_sum"], **out.get("metrics", {})}
            for k, v in values.items():
                if k not in sums:
                    sums[k] = torch.zeros((), device=self.device)
                sums[k] += v.detach()

    def _dispatch_train(self, epoch: int) -> dict:
        """Queue one train epoch; its device sums."""
        self.callback_handler.on_train_step_begin(
            self.training_config, train_loader=self.train_loader, epoch=epoch)
        self.model.train()
        self.train_loader.set_epoch(epoch)
        return self._run_epoch(self.train_loader, epoch, self.generator, train=True)

    def _dispatch_eval(self, epoch: int) -> dict:
        """Queue one eval epoch (no grad); its device sums."""
        self.callback_handler.on_eval_step_begin(
            self.training_config, eval_loader=self.eval_loader, epoch=epoch)
        self.model.eval()
        self._eval_generator.manual_seed(self.training_config.seed + 1000 + epoch)
        with torch.no_grad():
            return self._run_epoch(self.eval_loader, epoch, self._eval_generator, train=False)

    def _pack(self, sums: dict):
        """(one device vector of the sums, their names): a copy, so that the
        chunks' buffers may be zeroed for the next epoch; under a process
        group, summed over it (each rank's sums are its shares)."""
        vec = torch.stack([v.double() for v in sums.values()])
        if self.mesh.distributed:   # over the data axis: a model group's ranks agree
            torch.distributed.all_reduce(vec, group=self.mesh.data_group)
        return vec, list(sums)

    @staticmethod
    def _epoch_values(values, names, loader):
        """The epoch loss and metrics from the host values of ``_pack``:
        the loss sum over the dataset size, each metric sum over the batch
        count."""
        sums = dict(zip(names, values))
        loss = sums.pop("loss_sum") / len(loader.dataset)
        return loss, {k: v / len(loader) for k, v in sums.items()}

    def train_step(self, epoch: int):
        """One epoch over the train loader; returns (epoch_loss, metrics)."""
        vec, names = self._pack(self._dispatch_train(epoch))
        epoch_loss, metrics = self._epoch_values(vec.tolist(), names, self.train_loader)
        if not math.isfinite(epoch_loss):
            raise ArithmeticError("NaN detected in train loss")
        return epoch_loss, metrics

    def eval_step(self, epoch: int):
        """One epoch over the eval loader (no grad)."""
        vec, names = self._pack(self._dispatch_eval(epoch))
        epoch_loss, metrics = self._epoch_values(vec.tolist(), names, self.eval_loader)
        if not math.isfinite(epoch_loss):
            raise ArithmeticError("NaN detected in eval loss")
        return epoch_loss, metrics

    def _snapshot(self) -> dict:
        """The live weights, whole (under ``fsdp`` or a model axis a
        collective of every rank)."""
        if self._sharded:
            return self._state.whole_state_dict()
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _finalize_epoch(self, epoch, train_loss, train_metrics, eval_loss,
                        eval_metrics, candidate=None, deferred=False):
        """Scheduler step, best-model tracking, prediction grids,
        checkpoint and logging of one epoch. A ``deferred`` epoch's
        scheduler stepped when it was queued, and ``candidate`` holds the
        weights its window keeps (``_track_best``; None where no tracking
        can keep any); else the live weights are the epoch's."""
        cfg = self.training_config
        metrics = {"train_" + k: v for k, v in train_metrics.items()}
        metrics["train_epoch_loss"] = train_loss
        if eval_loss is not None:
            metrics["eval_epoch_loss"] = eval_loss
            metrics.update({"eval_" + k: v for k, v in eval_metrics.items()})
        if self.scheduler is not None and not deferred:
            if isinstance(self.scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau):
                self.scheduler.step(train_loss if eval_loss is None else eval_loss)
            else:
                self.scheduler.step()

        def snapshot():
            if not deferred:
                return self._snapshot()
            if candidate is None:
                raise RuntimeError(f"epoch {epoch} was deferred without its weights")
            return candidate

        if eval_loss is None:
            eval_loss = self.best_eval_loss
        if epoch <= self.start_keep_best_epoch:
            self._best_state = snapshot()
            logger.info("New model saved!")
        elif eval_loss < self.best_eval_loss and not cfg.keep_best_on_train:
            self.best_eval_loss = eval_loss
            self._best_state = snapshot()
            logger.info("New best model on eval saved!")
        elif train_loss < self.best_train_loss and cfg.keep_best_on_train:
            self.best_train_loss = train_loss
            self._best_state = snapshot()
            logger.info("New best model on train saved!")

        predicting = cfg.steps_predict is not None and (epoch % cfg.steps_predict == 0
                                                        or epoch == 1)
        # the grids are rank 0's: the live weights it may need whole first
        live = (self._snapshot() if predicting and self._sharded and self._best_state is None
                else None)
        if predicting and self.is_main_process:
            reconstructions = self._predict(epoch, live=live)
            self.callback_handler.on_prediction_step(
                cfg, reconstructions=reconstructions, global_step=epoch)
            for key, image in reconstructions.items():
                write_png(os.path.join(self.training_dir, f"recon_from_{key}.png"),
                          image)

        self.callback_handler.on_epoch_end(cfg)

        if cfg.steps_saving is not None and epoch % cfg.steps_saving == 0:
            self.save_checkpoint(dir_path=self.training_dir, epoch=epoch)
            if self.is_main_process:
                logger.info("Saved checkpoint at epoch %s", epoch)
            if self._file_logger is not None:
                self._file_logger.info(f"Saved checkpoint at epoch {epoch}\n")

        self.callback_handler.on_log(cfg, metrics, logger=logger, global_step=epoch)
        self.history.append(metrics)

    def train(self, log_output_dir: Optional[str] = None):
        """Main training loop, from epoch ``trained_epochs + 1`` (0 unless
        resumed). With ``log_output_dir``, the training parameters and each
        checkpoint's line also go to
        ``<log_output_dir>/training_logs_<training dir name>.log``."""
        cfg = self.training_config
        self.callback_handler.on_train_begin(cfg, model_config=self.model_config)
        msg = (
            f"Training params:\n - max_epochs: {cfg.num_epochs}\n"
            f" - per_device_train_batch_size: {cfg.per_device_train_batch_size}\n"
            f" - per_device_eval_batch_size: {cfg.per_device_eval_batch_size}\n"
            f" - checkpoint saving every: {cfg.steps_saving}\n"
            f" - device: {self.device}\n"
            f"Optimizer: {cfg.optimizer_cls} (lr={cfg.learning_rate})\n"
            f"Scheduler: {cfg.scheduler_cls}\n"
        )
        if self.is_main_process:
            logger.info(msg)
            if log_output_dir is not None:
                self._file_logger, handler = self._get_file_logger(log_output_dir)
                self._file_logger.info(msg)
            logger.info("Successfully launched training !\n")
        pipelined = self._pipeline_epochs_eligible()
        pending = []
        if self._state is not None:   # the modules' weights cut into the masters
            self._state.reshard()
        try:
            for epoch in range(self.trained_epochs + 1, cfg.num_epochs + 1):
                self.callback_handler.on_epoch_begin(
                    cfg, epoch=epoch, train_loader=self.train_loader,
                    eval_loader=self.eval_loader)
                self.best_train_loss, self.best_eval_loss = self.prepare_train_step(
                    epoch, self.best_train_loss, self.best_eval_loss)
                if not pipelined:
                    train_loss, train_metrics = self.train_step(epoch)
                    eval_loss = eval_metrics = None
                    if self.eval_dataset is not None:
                        eval_loss, eval_metrics = self.eval_step(epoch)
                    self._finalize_epoch(epoch, train_loss, train_metrics, eval_loss,
                                         eval_metrics)
                    continue
                train_sums = self._pack(self._dispatch_train(epoch))
                eval_sums = (self._pack(self._dispatch_eval(epoch))
                             if self.eval_dataset is not None else None)
                if not pending:
                    self._open_window()
                self._track_best(epoch, train_sums, eval_sums)
                if self.scheduler is not None:   # deterministic: its epoch's rate now
                    self.scheduler.step()
                pending.append((epoch, train_sums, eval_sums))
                if (epoch == cfg.num_epochs or self._epoch_needs_sync_finalize(epoch)
                        or len(pending) >= cfg.pipeline_depth):
                    self._finalize_pending(pending)
                    pending = []
            if pending:
                self._finalize_pending(pending)
        finally:
            if self._state is not None:   # the live weights whole in the modules again
                self._state.unshard()
            if self._file_logger is not None:
                # another trainer of this process must not write to this file
                self._file_logger.removeHandler(handler)
                handler.close()
                self._file_logger = None
        final_dir = os.path.join(self.training_dir, "final_model")
        if self.is_main_process:
            self.save_model(final_dir)
            logger.info("Training ended! Saved final model in %s", final_dir)
        # every save committed when train() returns, and the writer stopped
        self.wait_for_checkpoint()
        if self._checkpointer is not None:
            self._checkpointer.close()
        self._barrier()   # the final model is on disk when train() returns
        self.callback_handler.on_train_end(cfg)

    def _barrier(self):
        """Wait for every process of the group (none: return)."""
        if self.mesh.distributed:
            torch.distributed.barrier(
                device_ids=[self.device.index] if self.mesh.backend == "nccl" else None)

    # ------------------------------------------------ pipelined finalization
    def _pipeline_epochs_eligible(self) -> bool:
        """May the epochs' host side lag behind the device (JAX
        ``_pipeline_epochs_eligible`` / ``_deferred_finalize_safe``)? Not
        with ``ReduceLROnPlateau``, which needs each epoch's loss before the
        next epoch's rate; not where a subclass replaced ``train_step`` or
        ``eval_step``, or ``prepare_train_step`` without declaring its
        boundary epochs; not where an instance replaced one of these hooks
        or ``_finalize_epoch``; and not with a callback other than the
        display ones that has its own ``on_epoch_end``, which would see a
        later epoch's state."""
        if not self.training_config.pipeline_epochs:
            return False
        if isinstance(self.scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau):
            return False
        cls = type(self)
        if not (cls.train_step is BaseTrainer.train_step
                and cls.eval_step is BaseTrainer.eval_step):
            return False
        hooks = ("train_step", "eval_step", "prepare_train_step", "_finalize_epoch")
        if any(name in vars(self) for name in hooks):
            return False
        if self._prepare_boundaries() is None:
            return False
        for cb in self.callback_handler.callbacks:
            if isinstance(cb, (ProgressBarCallback, MetricConsolePrinterCallback)):
                continue
            if type(cb).on_epoch_end is not TrainingCallback.on_epoch_end:
                return False
        return True

    def _open_window(self):
        """Start a window of deferred epochs: its candidate starts from the
        host's best loss, in a new buffer where the last window's became the
        kept weights."""
        cfg = self.training_config
        best = self.best_train_loss if cfg.keep_best_on_train else self.best_eval_loss
        state = None if self._candidate is None else self._candidate["state"]
        if state is self._best_state:
            state = None
        self._candidate = {"state": state, "best": torch.full(
            (), best, dtype=torch.float64, device=self.device),
            # 0: no epoch of this window held yet
            "epoch": torch.zeros((), dtype=torch.float64, device=self.device)}

    def _track_best(self, epoch: int, train_sums, eval_sums):
        """Best-model tracking's copy of a deferred epoch's weights, made on
        the device when the epoch is queued (its finalization may come
        epochs later), into the window's one candidate buffer: always in the
        model's keep-best warm-up, else where the tracked loss (eval, or
        train with ``keep_best_on_train``) beats the best so far, the
        comparison the finalization then makes on the host in the same
        float64. The buffer ends the window holding the weights the
        finalization keeps last, and ``epoch`` names their epoch."""
        cfg = self.training_config
        if epoch <= self.start_keep_best_epoch:
            tracked = None
        elif cfg.keep_best_on_train:
            tracked = (train_sums, self.train_loader)
        elif eval_sums is not None:
            tracked = (eval_sums, self.eval_loader)
        else:   # no eval loss: no later epoch beats the best
            return
        cand = self._candidate
        live = self._state.whole_state_dict() if self._sharded else self.model.state_dict()
        if cand["state"] is None:
            cand["state"] = {k: torch.empty_like(v) for k, v in live.items()}
        if tracked is None:
            for k, v in live.items():
                cand["state"][k].copy_(v)
            cand["epoch"].fill_(epoch)
            return
        (vec, names), loader = tracked
        loss = vec[names.index("loss_sum")] / len(loader.dataset)
        better = loss < cand["best"]
        cand["best"] = torch.where(better, loss, cand["best"])
        cand["epoch"].masked_fill_(better, epoch)
        for k, v in live.items():
            cand["state"][k].copy_(torch.where(better, v.detach(), cand["state"][k]))

    def _epoch_needs_sync_finalize(self, epoch: int) -> bool:
        """Checkpoint and prediction epochs read the live state on the host,
        as does the boundary's ``prepare_train_step`` after the epoch
        before it: these finalize at once."""
        cfg = self.training_config
        if cfg.steps_saving is not None and epoch % cfg.steps_saving == 0:
            return True
        if (epoch + 1) in self._prepare_boundaries():
            return True
        return cfg.steps_predict is not None and (epoch % cfg.steps_predict == 0
                                                  or epoch == 1)

    def _finalize_pending(self, pending):
        """Finalize the deferred epochs ``(epoch, train sums, eval sums)``
        in order, their sums and the candidate's epoch fetched in one
        transfer; the epoch whose weights the host keeps last must be the
        candidate's."""
        vecs = [sums[0] for _, train, ev in pending for sums in (train, ev)
                if sums is not None]
        values = torch.cat(vecs + [self._candidate["epoch"].view(1)]).tolist()
        held = int(values.pop())
        pos = 0

        def take(packed, loader):
            nonlocal pos
            n = len(packed[1])
            out = self._epoch_values(values[pos:pos + n], packed[1], loader)
            pos += n
            return out

        kept = None
        for epoch, train, ev in pending:
            train_loss, train_metrics = take(train, self.train_loader)
            if not math.isfinite(train_loss):
                raise ArithmeticError("NaN detected in train loss")
            eval_loss = eval_metrics = None
            if ev is not None:
                eval_loss, eval_metrics = take(ev, self.eval_loader)
                if not math.isfinite(eval_loss):
                    raise ArithmeticError("NaN detected in eval loss")
            best = (self.best_train_loss, self.best_eval_loss)
            self._finalize_epoch(epoch, train_loss, train_metrics, eval_loss, eval_metrics,
                                 self._candidate["state"], deferred=True)
            if epoch <= self.start_keep_best_epoch or best != (self.best_train_loss,
                                                               self.best_eval_loss):
                kept = epoch
        if kept is not None and kept != held:
            raise RuntimeError(f"best-model tracking kept epoch {kept} on the host, "
                               f"but the device's candidate holds epoch {held}")

    def _get_file_logger(self, log_output_dir: str):
        """(the logger of ``training_logs_<training dir name>.log`` in
        ``log_output_dir``, its file handler)."""
        os.makedirs(log_output_dir, exist_ok=True)
        log_name = f"training_logs_{os.path.basename(self.training_dir)}"
        file_logger = logging.getLogger(log_name)
        file_logger.setLevel(logging.INFO)
        handler = logging.FileHandler(os.path.join(log_output_dir, f"{log_name}.log"))
        file_logger.addHandler(handler)
        return file_logger, handler

    # ---------------------------------------------------------- kept weights
    def _restore_best(self):
        """Load the kept weights into the model (none kept: keep the live
        ones); under ``fsdp`` or a model axis into the masters."""
        if self._best_state is None:
            return
        if self._sharded:
            self._state.load_whole(self._best_state)
        else:
            self.model.load_state_dict(self._best_state)

    @property
    def best_model(self):
        """The model with the kept weights loaded."""
        self._restore_best()
        return self.model

    @contextlib.contextmanager
    def _with_best_weights(self, live=None):
        """The kept weights in the model inside the block, the live ones
        again after it. Under ``fsdp`` or a model axis, the whole kept
        weights (else ``live``, else the live ones gathered) in plain
        modules."""
        if self._sharded:
            state = self._best_state if self._best_state is not None else live
            with self._state.whole_weights(state if state is not None
                                           else self._snapshot()):
                yield
            return
        if self._best_state is None:
            yield
            return
        live = self._snapshot()
        self.model.load_state_dict(self._best_state)
        try:
            yield
        finally:
            self.model.load_state_dict(live)

    # ------------------------------------------------------------ save/load
    def save_model(self, dir_path: str):
        """Save the kept model and the training config."""
        os.makedirs(dir_path, exist_ok=True)
        self.model.save(dir_path, state_dict=self._best_state)
        self.training_config.save_json(dir_path, "training_config")
        self.callback_handler.on_save(self.training_config, dir_path=dir_path)

    def save_checkpoint(self, dir_path: str, epoch: int):
        """``<dir_path>/checkpoint_epoch_<epoch>``: the kept model, the live
        weights, the optimizer's, scheduler's and training generator's
        states, the training config and the loop's counters. A collective
        of every rank. With ``checkpoint_backend="msgpack"`` rank 0 writes
        it all, whole, and every rank leaves when it is on disk. With
        ``"orbax"`` every rank, once the save before is committed, writes
        its pieces of the live weights and the optimizer's state into
        ``train_state/`` (rank 0 also the generator's state), in the
        background where ``async_checkpointing``; rank 0 writes the rest at
        once, as the msgpack path does."""
        cfg = self.training_config
        if cfg.checkpoint_backend == "orbax":
            self.wait_for_checkpoint()
            t0 = time.perf_counter()
            if self._checkpointer is None:
                self._checkpointer = Checkpointer(self.mesh, self._barrier)
            self._checkpointer.save(
                os.path.join(dir_path, f"checkpoint_epoch_{epoch}", STATE_DIR),
                self._layout(), self.optimizer, self.generator.get_state(), cfg.fsdp)
            # the kept weights are whole on every rank: the live ones are
            # gathered only for a model file without them (JAX best_params)
            live = (self._state.whole_state_dict()
                    if self._sharded and self._best_state is None else None)
            if self.is_main_process:
                self._write_checkpoint(dir_path, epoch, live, sharded=True)
            self.checkpoint_times = {"blocked_s": time.perf_counter() - t0,
                                     **self._checkpointer.last}
            if not cfg.async_checkpointing:
                self.wait_for_checkpoint()
            return
        t0 = time.perf_counter()
        # whole, as a replicated run writes them
        live = self._state.whole_state_dict() if self._sharded else None
        optimizer = (self._state.optimizer_state_whole(self.optimizer)
                     if self._state is not None else None)
        if self.is_main_process:
            self._write_checkpoint(dir_path, epoch, live, optimizer)
        self._barrier()
        self.checkpoint_times = {"blocked_s": time.perf_counter() - t0}

    def wait_for_checkpoint(self):
        """Block until the pending sharded save, if any, is committed to
        disk (JAX name): before the next save, before a resume, at the end
        of ``train()`` and after the ``MultistageTrainer``'s boundary save.
        A collective of every rank where a save is pending; an error of any
        rank's writer raises here, on every rank."""
        if self._checkpointer is not None:
            self._checkpointer.wait()
            self.checkpoint_times.update(self._checkpointer.last)

    def _layout(self) -> ShardedState:
        """The parameters by their placements: the trainer's state, else (one
        process, no leaf cut) a mesh of one over the model's own
        parameters."""
        if self._state is not None:
            return self._state
        return ShardedState(self.model, self.mesh, fsdp=False)

    def _write_checkpoint(self, dir_path: str, epoch: int, live=None, optimizer=None,
                          sharded: bool = False):
        checkpoint_dir = os.path.join(dir_path, f"checkpoint_epoch_{epoch}")
        os.makedirs(checkpoint_dir, exist_ok=True)
        if not sharded:
            torch.save(optimizer if optimizer is not None else self.optimizer.state_dict(),
                       os.path.join(checkpoint_dir, "optimizer.pt"))
            # The model files hold the kept weights, which are not those
            # training goes on from whenever the loss is not monotonic: the
            # live weights and the generator's state ride beside them, so a
            # resume repeats the uninterrupted run.
            torch.save(live if live is not None else self.model.state_dict(),
                       os.path.join(checkpoint_dir, "live_params.pt"))
            torch.save(self.generator.get_state(),
                       os.path.join(checkpoint_dir, "generator.pt"))
        if self.scheduler is not None:
            with open(os.path.join(checkpoint_dir, "scheduler.json"), "w") as f:
                # a capturable optimizer's rates are 0-d tensors
                json.dump(self.scheduler.state_dict(), f, default=_tensor_item)
        self.model.save(checkpoint_dir, state_dict=self._best_state if self._best_state is not None
                        else live)
        self.training_config.save_json(checkpoint_dir, "training_config")
        info = dict(training_dir=self.training_dir, trained_epochs=epoch,
                    best_train_loss=self.best_train_loss,
                    best_eval_loss=self.best_eval_loss)
        with open(os.path.join(checkpoint_dir, "info_checkpoint.json"), "w") as fp:
            json.dump(info, fp, sort_keys=True, indent=4)
        self.callback_handler.on_save_checkpoint(self.training_config,
                                                 checkpoint_dir=checkpoint_dir)

    def _load(self, checkpoint_dir: str, name: str):
        return torch.load(os.path.join(checkpoint_dir, name),
                          map_location=self.device, weights_only=True)

    def _resume_from_checkpoint(self, checkpoint_dir: str):
        """Load the weights, the optimizer's, scheduler's and generator's
        states and the counters of a checkpoint: the live ones from its
        ``train_state/`` where it has one (whatever this trainer's
        backend, as in JAX), into this trainer's layout; else from its
        whole files."""
        self.wait_for_checkpoint()
        with open(os.path.join(checkpoint_dir, "info_checkpoint.json")) as fp:
            info = json.load(fp)
        self.trained_epochs = info["trained_epochs"]
        self.best_train_loss = info["best_train_loss"]
        self.best_eval_loss = info["best_eval_loss"]

        self._best_state = self._load(checkpoint_dir, "model.pt")
        if is_sharded(checkpoint_dir):
            self.generator.set_state(Checkpointer.restore(
                os.path.join(checkpoint_dir, STATE_DIR), self._layout(), self.optimizer))
        else:
            self._load_whole_files(checkpoint_dir)
        sch_path = os.path.join(checkpoint_dir, "scheduler.json")
        if self.scheduler is not None and os.path.exists(sch_path):
            with open(sch_path) as f:
                state = json.load(f)
            if "milestones" in state:
                # MultiStepLR keeps a Counter of int epochs; JSON made its
                # keys strings, which no epoch would ever match again
                state["milestones"] = collections.Counter(
                    {int(k): v for k, v in state["milestones"].items()})
            self.scheduler.load_state_dict(state)
        if self._graphed:   # the loaded state may be a synchronous run's
            make_capturable(self.optimizer)
        self._drop_graphs()

    def _load_whole_files(self, checkpoint_dir: str):
        """The live weights, the optimizer's and the generator's states of a
        checkpoint's whole files (``live_params.pt``, ``optimizer.pt``,
        ``generator.pt``)."""
        live, optimizer = (self._load(checkpoint_dir, name)
                           for name in ("live_params.pt", "optimizer.pt"))
        # whole files, either layout's: cut into the masters where they are used
        if self._sharded:
            self._state.load_whole(live)
        else:
            self.model.load_state_dict(live)
        if self._state is not None:
            self._state.load_optimizer_whole(self.optimizer, optimizer)
        else:
            self.optimizer.load_state_dict(optimizer)
        # without the generator's state the run goes on, from the seed's
        # noise instead of the uninterrupted run's
        gen_path = os.path.join(checkpoint_dir, "generator.pt")
        if os.path.exists(gen_path):
            self.generator.set_state(torch.load(gen_path, weights_only=True))

    # ----------------------------------------------------------- prediction
    def predict(self, epoch: int = 0, n_data: int = 8) -> dict:
        """Reconstruction grids of the first ``n_data`` rows of the eval set
        (else the train set) with the kept weights, each an (H, W, 3) uint8
        array: from each modality and from all of them (8 draws each), or
        for a conditional model (CVAE) its main modality from all. The
        draws come from a generator seeded with the training seed. Under
        ``fsdp`` or a model axis without kept weights, a collective of every
        rank."""
        return self._predict(epoch, n_data)

    @torch.no_grad()
    def _predict(self, epoch: int = 0, n_data: int = 8, live=None) -> dict:
        """``predict``, with ``live`` the whole live weights where they were
        gathered already (the grids of rank 0 alone)."""
        predict_dataset = (self.eval_dataset if self.eval_dataset is not None
                           else self.train_dataset)
        raw = predict_dataset.get_batch(np.arange(min(n_data, len(predict_dataset))))
        inputs_data = raw["data"]
        batch = batch_from_arrays(data=inputs_data)
        generator = torch.Generator(device=self.device).manual_seed(
            self.training_config.seed)
        model = self.model

        def plot(x, m):
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            return predict_dataset.transform_for_plotting(x, modality=m)

        def grid(rows):
            return grid_to_image(make_grid(np.concatenate(rows, 0), nrow=n_data))

        all_recons = {}
        if not isinstance(model, BaseMultiVAE):
            if hasattr(model, "main_modality"):
                main = model.main_modality
                with self._with_best_weights(live):
                    recon = model.predict(batch, cond_mod="all", N=8, flatten=True,
                                          generator=generator)
                grids, _ = adapt_shape({main: plot(recon[main], main),
                                        "true_data": plot(inputs_data[main], main)})
                all_recons["all"] = grid([grids["true_data"], grids[main]])
            return all_recons

        with self._with_best_weights(live):
            for mod in inputs_data:
                recon = model.predict(batch, mod, "all", N=8, flatten=True,
                                      generator=generator, ignore_incomplete=True)
                recon = {m: plot(recon[m], m) for m in recon}
                recon["true_data"] = plot(inputs_data[mod], mod)
                recon, _ = adapt_shape(recon)
                all_recons[mod] = grid([recon["true_data"]] + [
                    recon[m] for m in recon if m != "true_data"])

            # joint reconstruction conditioned on all modalities
            recon = model.predict(batch, "all", "all", N=8, flatten=True,
                                  generator=generator, ignore_incomplete=True)
            gen_mods = list(recon.keys())
            recon = {m: plot(recon[m], m) for m in recon}
            for m in inputs_data:
                recon[f"true_data_{m}"] = plot(inputs_data[m], m)
            recon, _ = adapt_shape(recon)
            all_recons["all"] = grid([recon[f"true_data_{m}"] for m in inputs_data]
                                     + [recon[m] for m in gen_mods])
        return all_recons
