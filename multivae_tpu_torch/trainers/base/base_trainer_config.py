"""Trainer config (counterpart of
``multivae_tpu/trainers/base/base_trainer_config.py``).

Keeps the JAX package's field names for the options the port's
synchronous loop implements. The TPU-only fields (meshes, FSDP, device
caches, fused epoch blocks, pipelining, microbatching, orbax) are not part
of the port; a ``training_config.json`` holding them does not load here.
Optimizer and scheduler specs are validated eagerly.
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
        seed: seed of the data order and of the sampling generator.
        drop_last: drop the final partial batch instead of padding it.
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
    seed: int = 8
    drop_last: bool = False

    def __post_init__(self):
        check_specs(self.optimizer_cls, self.learning_rate,
                    self.optimizer_params, self.scheduler_cls,
                    self.scheduler_params)
