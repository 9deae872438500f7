"""Trainer config (counterpart of
``multivae_tpu/trainers/base/base_trainer_config.py``).

Keeps the JAX package's field names for the options the port's
synchronous loop implements, the device cache's three among them. The
other TPU-only fields (meshes, FSDP, fused epoch blocks and
``steps_per_execution``, pipelining, orbax checkpoints, bfloat16) are not
part of the port; a ``training_config.json`` holding them does not load
here. Optimizer and scheduler specs are validated eagerly.
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
            batch (one device).
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

    def __post_init__(self):
        if self.microbatch_steps < 1:
            raise AttributeError(
                "microbatch_steps must be a positive integer, got "
                f"{self.microbatch_steps}."
            )
        if self.device_cache_layout not in ("auto", "replicated", "sharded"):
            raise AttributeError(
                "device_cache_layout must be 'auto', 'replicated' or "
                f"'sharded', got {self.device_cache_layout!r}."
            )
        check_specs(self.optimizer_cls, self.learning_rate,
                    self.optimizer_params, self.scheduler_cls,
                    self.scheduler_params)
