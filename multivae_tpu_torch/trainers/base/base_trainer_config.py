"""Trainer config (counterpart of
``multivae_tpu/trainers/base/base_trainer_config.py``).

Keeps the JAX package's field names for the options the port implements:
the device cache's three, ``steps_per_execution`` (CUDA graphs of the
cached step on the card), the pipelined finalization's two, data
parallelism's four (``n_devices``, ``coordinator_address``,
``num_processes``, ``process_id``: one process per card over a
``torch.distributed`` group, ``parallel/mesh.py``), the state's sharding
(``fsdp``, ``n_model_devices``: ``parallel/state.py``) and bfloat16's
``mixed_precision`` (the trainer's ``_train_loss``). The JAX package's
other fields load at their defaults, so that a ``training_config.json``
it saved loads unedited. ``checkpoint_backend`` and
``async_checkpointing`` keep the JAX meaning: "msgpack" writes the whole
state from rank 0, "orbax" the train state sharded, each rank its own
pieces, in the background where ``async_checkpointing`` is on
(``checkpoint.py``). The port's files are torch files in both: "orbax"
names the feature, not orbax's format, which the port neither writes nor
reads. Optimizer and scheduler specs are validated eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...utils.config import BaseConfig
from .optim import check_specs


@dataclasses.dataclass
class BaseTrainerConfig(BaseConfig):
    """Main training arguments.

    Args:
        output_dir: where the final model goes.
        per_device_train_batch_size / per_device_eval_batch_size: rows per
            batch on each device; the global batch is this times the number
            of processes.
        num_epochs: training epochs.
        optimizer_cls: ``torch.optim`` optimizer by name (Adam, AdamW, SGD,
            RMSprop, Adagrad, Adadelta, Adamax, RAdam).
        optimizer_params: extra optimizer kwargs (torch names; optax's
            ``b1``/``b2`` are accepted).
        scheduler_cls: ``torch.optim.lr_scheduler`` class name or None,
            stepped once per epoch (ReduceLROnPlateau on the eval loss, or
            the train loss without an eval set).
        scheduler_params: scheduler kwargs.
        learning_rate: base learning rate.
        steps_saving: save a checkpoint every N epochs (None: never).
        steps_predict: write the prediction grids every N epochs and at
            epoch 1 (None: never).
        keep_best_on_train: keep the weights of the best train loss instead
            of the best eval loss.
        seed: seed of the data order and of the sampling generator.
        drop_last: drop the final partial batch instead of padding it.
        microbatch_steps: accumulate each step's gradient over N equal
            chunks of the batch (``ops/microbatch.py``), each holding its
            activations only through its own backward. Exact for the
            objectives that are sums over the rows (the model declares
            ``loss_is_sum = True``: MMVAE, MMVAE+, CMVAE); each chunk draws
            its own noise, in chunk order. 1 (default) is off.
        cache_on_device: upload the train and eval sets to the device once
            (``data/device_cache.py``) and gather each batch there; the
            batches are bit-identical to the host loader's. A set that does
            not fit ``device_cache_budget_gb`` (the eval set: what the
            train set leaves of it) or cannot be indexed in bulk is read
            from the host, with a warning.
        device_cache_budget_gb: device memory the caches may take.
        device_cache_layout: "auto", "replicated" or "sharded" (all keep
            the whole set on the one device).
        steps_per_execution: run the train and eval steps of an epoch in
            chunks of this many over the device cache (requires
            ``cache_on_device``): on CUDA each chunk is one replayed CUDA
            graph, so the host launches once a chunk; the per-step
            callbacks fire after each chunk. 1 (default): a step at a time.
            A set that fell back to the host loader steps one at a time.
        pipeline_epochs: defer each epoch's host side (loss fetch, NaN
            guard, best-model tracking, logging, ``on_epoch_end``) by up to
            ``pipeline_depth`` epochs, so the host queues the next epochs
            while the device works. Logged values equal the synchronous
            loop's; they arrive in bursts, and a NaN shows up to
            ``pipeline_depth`` epochs late. Checkpoint and prediction
            epochs, the epoch before a ``prepare_train_step`` boundary and
            the last epoch finalize at once. Off by itself with
            ``ReduceLROnPlateau``, with replaced step hooks and with a
            callback that has its own ``on_epoch_end``. On by default, as
            in the JAX package.
        pipeline_depth: the most epochs finalization may lag; each keeps a
            copy of the weights on the device until then where best-model
            tracking may keep them.
        n_devices: the size of the data axis, one process and card each
            (None: the process group's size over ``n_model_devices``, 1
            without one); the group must hold ``n_devices x
            n_model_devices`` processes, or this raises.
        fsdp: keep each large float parameter and its optimizer state as
            this process's 1/``n_devices`` piece (the JAX rule's leaves),
            gathered for each step, the gradients reduce-scattered.
        n_model_devices: the size of the model axis: adjacent ranks compute
            the output columns of each wide Linear and convolution (the JAX
            rule's leaves) and gather the activations.
        coordinator_address / num_processes / process_id: open the process
            group at ``host:port`` with this many processes, this one being
            ``process_id``; unset, a group opened by the caller or by
            torchrun (its ``env://`` variables) is joined.
        checkpoint_backend: "msgpack" (default: rank 0 writes the whole
            live weights and optimizer state, ``live_params.pt`` and
            ``optimizer.pt``, gathered over the ranks) or "orbax" (the train
            state in ``train_state/``, sharded: each rank writes the pieces
            it holds, no gather; any layout restores it).
        async_checkpointing: with "orbax", a save returns once this rank's
            pieces are copied to host memory, and a background thread writes
            them; the trainer waits for the commit before the next save,
            before a resume and at the end of ``train()``
            (``wait_for_checkpoint``). False: every save waits for its own.
            Without effect with "msgpack". Default True.
        mixed_precision: run each train step's loss in bfloat16 (fp32
            master weights and optimizer state; grads are cast back to
            fp32): the loss on bf16 copies of the parameters and of the
            batch's float leaves, the gradients through the casts to the
            float32 parameters. The eval pass stays float32. Off by
            default.
    """

    output_dir: Optional[str] = None
    per_device_train_batch_size: int = 64
    per_device_eval_batch_size: int = 64
    num_epochs: int = 100
    optimizer_cls: str = "Adam"
    optimizer_params: Optional[dict] = None
    scheduler_cls: Optional[str] = None
    scheduler_params: Optional[dict] = None
    learning_rate: float = 1e-4
    steps_saving: Optional[int] = None
    steps_predict: Optional[int] = None
    keep_best_on_train: bool = False
    seed: int = 8
    drop_last: bool = False
    microbatch_steps: int = 1
    cache_on_device: bool = False
    device_cache_budget_gb: float = 8.0
    device_cache_layout: str = "auto"
    steps_per_execution: int = 1
    pipeline_epochs: bool = True
    pipeline_depth: int = 8
    n_devices: Optional[int] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    mixed_precision: bool = False
    fsdp: bool = False
    n_model_devices: int = 1
    checkpoint_backend: str = "msgpack"
    async_checkpointing: bool = True

    def __post_init__(self):
        # the JAX package's own checks first, with its messages
        if self.checkpoint_backend not in ("msgpack", "orbax"):
            raise AttributeError(
                "checkpoint_backend must be 'msgpack' or 'orbax', got "
                f"{self.checkpoint_backend!r}."
            )
        if self.n_model_devices < 1:
            raise AttributeError(
                "n_model_devices must be a positive integer, got "
                f"{self.n_model_devices}."
            )
        if self.steps_per_execution < 1:
            raise AttributeError(
                "steps_per_execution must be a positive integer, got "
                f"{self.steps_per_execution}."
            )
        if self.microbatch_steps < 1:
            raise AttributeError(
                "microbatch_steps must be a positive integer, got "
                f"{self.microbatch_steps}."
            )
        if self.pipeline_depth < 1:
            raise AttributeError(
                "pipeline_depth must be a positive integer, got "
                f"{self.pipeline_depth}."
            )
        if self.n_devices is not None and self.n_devices < 1:
            raise AttributeError(
                f"n_devices must be a positive integer or None, got {self.n_devices}.")
        if self.device_cache_layout not in ("auto", "replicated", "sharded"):
            raise AttributeError(
                "device_cache_layout must be 'auto', 'replicated' or "
                f"'sharded', got {self.device_cache_layout!r}."
            )
        if self.steps_per_execution > 1 and not self.cache_on_device:
            raise AttributeError(
                "steps_per_execution > 1 requires cache_on_device=True "
                "(fused multi-step dispatch gathers batches on device)."
            )
        check_specs(self.optimizer_cls, self.learning_rate,
                    self.optimizer_params, self.scheduler_cls,
                    self.scheduler_params)
