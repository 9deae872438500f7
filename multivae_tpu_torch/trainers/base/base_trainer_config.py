"""Trainer config (counterpart of
``multivae_tpu/trainers/base/base_trainer_config.py``).

Keeps the JAX package's field names for the options the port's
synchronous loop implements. The TPU-only fields (meshes, FSDP, device
caches, fused epoch blocks, pipelining, orbax) are not part of the port; a
``training_config.json`` holding them does not load here.
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

    def __post_init__(self):
        if self.microbatch_steps < 1:
            raise AttributeError(
                "microbatch_steps must be a positive integer, got "
                f"{self.microbatch_steps}."
            )
        check_specs(self.optimizer_cls, self.learning_rate,
                    self.optimizer_params, self.scheduler_cls,
                    self.scheduler_params)
