"""Single-device epoch trainer (counterpart of the synchronous loop of
``multivae_tpu/trainers/base/base_trainer.py``: ``train_step``,
``eval_step`` and ``train``).

Per epoch: the ``prepare_train_step`` hook (the ``MultistageTrainer``'s
optimizer reset), the loader's seeded permutation, one optimizer step per
batch, the epoch loss as the sum of the batches' ``loss_sum`` over the
dataset size, a NaN guard, the scheduler step, best-model tracking. Up to
the model's ``start_keep_best_epoch`` (0 unless the model sets it, as
MVAE's and JMVAE's warm-ups do) every epoch's weights are kept; after it,
those of the best eval loss, where an epoch without an eval set counts as
no better than the best so far, so the last warm-up epoch's weights stay.
At the end the kept weights (the live ones when none were kept) are
saved with the training config in
``<output_dir>/<model>_training_<time>/final_model``; ``best_model`` loads
them into the model.

Sampling noise comes from one ``torch.Generator`` on the device, seeded
with ``training_config.seed`` and advanced step after step; each eval pass
draws from a generator seeded with ``seed + 1000 + epoch``.

The JAX trainer's fused epoch blocks, device cache, prefetch, pipelined
finalization and microbatching exist to amortize TPU launch costs and are
not part of the port; nor are checkpoint/resume, prediction grids,
callbacks and ``keep_best_on_train`` yet.
``history`` holds each epoch's logged metrics.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from typing import Optional

import torch

from ...data.loader import DataLoader
from ...models.base.base_model import BaseModel
from ...models.base.step import StepInfo
from ...utils.device import resolve_device
from .base_trainer_config import BaseTrainerConfig
from .optim import make_optimizer, make_scheduler

logger = logging.getLogger(__name__)


def _add_into(sums: dict, values: dict):
    for k, v in values.items():
        sums[k] = sums[k] + v if k in sums else v


class BaseTrainer:
    """Epoch trainer on one device.

    Args:
        model: a BaseMultiVAE (or BaseModel); moved to ``device``.
        train_dataset / eval_dataset: MultimodalBaseDataset instances.
        training_config: BaseTrainerConfig.
        device: where training runs (default "cuda"; raises when CUDA is
            absent).

    A model that defines ``reset_optimizer_epochs`` (TELBO, JNF) needs the
    ``MultistageTrainer`` and is refused here.
    """

    def __init__(self, model: BaseModel, train_dataset, eval_dataset=None,
                 training_config: Optional[BaseTrainerConfig] = None,
                 device="cuda"):
        self.checktrainer(model)
        if training_config is None:
            training_config = BaseTrainerConfig()
        if training_config.output_dir is None:
            training_config.output_dir = "dummy_output_dir"
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.training_config = training_config
        cfg = training_config

        self.train_loader = DataLoader(
            train_dataset, cfg.per_device_train_batch_size, shuffle=True,
            seed=cfg.seed, drop_last=cfg.drop_last)
        self.eval_loader = (
            DataLoader(eval_dataset, cfg.per_device_eval_batch_size,
                       shuffle=False, seed=cfg.seed, drop_last=cfg.drop_last)
            if eval_dataset is not None else None)

        self.optimizer = make_optimizer(cfg.optimizer_cls, model.parameters(),
                                        cfg.learning_rate, cfg.optimizer_params)
        self.scheduler = make_scheduler(cfg.scheduler_cls, self.optimizer,
                                        cfg.scheduler_params)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        self.best_train_loss = math.inf
        self.best_eval_loss = math.inf
        self._best_state = None
        self.start_keep_best_epoch = getattr(model, "start_keep_best_epoch", 0)
        self.history = []

        signature = (str(datetime.datetime.now())[:19]
                     .replace(" ", "_").replace(":", "-"))
        self.training_dir = os.path.join(
            cfg.output_dir,
            f"{getattr(model, 'model_name', type(model).__name__)}"
            f"_training_{signature}")
        os.makedirs(self.training_dir, exist_ok=True)

    def checktrainer(self, model):
        """Refuse models that need multistage training."""
        if getattr(model, "reset_optimizer_epochs", None):
            raise AttributeError(
                f"The model {type(model).__name__} requires the "
                "MultistageTrainer for training (it defines "
                "reset_optimizer_epochs). Please use "
                "multivae_tpu_torch.trainers.MultistageTrainer instead of "
                "BaseTrainer.")

    def prepare_train_step(self, epoch, best_train_loss, best_eval_loss):
        """Hook for changes between epochs (the ``MultistageTrainer``'s
        optimizer reset); returns the best train and eval losses to go on
        with."""
        return best_train_loss, best_eval_loss

    # ------------------------------------------------------------- stepping
    def _run_epoch(self, loader, epoch: int, generator, train: bool):
        n_batches = len(loader)
        dataset_size = len(loader.dataset)
        loss_sum = torch.zeros((), device=self.device)
        metric_sums = {}
        for batch_idx, batch in enumerate(loader):
            batch = batch.to(self.device, non_blocking=True)
            # the eval pass leaves batch_ratio at 0, as the JAX trainer does
            info = StepInfo(epoch=epoch, batch_ratio=batch_idx / n_batches if train else 0.0,
                            dataset_size=dataset_size)
            out = self.model.loss_function(batch, info, generator=generator)
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                out["loss"].backward()
                self.optimizer.step()
            loss_sum += out["loss_sum"].detach()
            _add_into(metric_sums, {k: v.detach()
                                    for k, v in out.get("metrics", {}).items()})
        epoch_loss = loss_sum.item() / dataset_size
        metrics = {k: float(v) / n_batches for k, v in metric_sums.items()}
        return epoch_loss, metrics

    def train_step(self, epoch: int):
        """One epoch over the train loader; returns (epoch_loss, metrics)."""
        self.model.train()
        self.train_loader.set_epoch(epoch)
        epoch_loss, metrics = self._run_epoch(self.train_loader, epoch,
                                              self.generator, train=True)
        if not math.isfinite(epoch_loss):
            raise ArithmeticError("NaN detected in train loss")
        return epoch_loss, metrics

    def eval_step(self, epoch: int):
        """One epoch over the eval loader (no grad)."""
        self.model.eval()
        generator = torch.Generator(device=self.device).manual_seed(
            self.training_config.seed + 1000 + epoch)
        with torch.no_grad():
            epoch_loss, metrics = self._run_epoch(self.eval_loader, epoch,
                                                  generator, train=False)
        if not math.isfinite(epoch_loss):
            raise ArithmeticError("NaN detected in eval loss")
        return epoch_loss, metrics

    def _snapshot(self) -> dict:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _finalize_epoch(self, epoch, train_loss, train_metrics, eval_loss,
                        eval_metrics):
        """Scheduler step, best-model tracking and logging of one epoch."""
        metrics = {"train_" + k: v for k, v in train_metrics.items()}
        metrics["train_epoch_loss"] = train_loss
        if eval_loss is not None:
            metrics["eval_epoch_loss"] = eval_loss
            metrics.update({"eval_" + k: v for k, v in eval_metrics.items()})
        if self.scheduler is not None:
            if isinstance(self.scheduler, torch.optim.lr_scheduler.ReduceLROnPlateau):
                self.scheduler.step(train_loss if eval_loss is None else eval_loss)
            else:
                self.scheduler.step()

        if eval_loss is None:
            eval_loss = self.best_eval_loss
        if epoch <= self.start_keep_best_epoch:
            self._best_state = self._snapshot()
            logger.info("New model saved!")
        elif eval_loss < self.best_eval_loss:
            self.best_eval_loss = eval_loss
            self._best_state = self._snapshot()
            logger.info("New best model on eval saved!")

        self.history.append(metrics)
        logger.info("Epoch %d: %s", epoch, metrics)

    def train(self):
        """Main training loop."""
        cfg = self.training_config
        logger.info("Training on %s: %d epochs, batch %d, %s (lr=%g)",
                    self.device, cfg.num_epochs, cfg.per_device_train_batch_size,
                    cfg.optimizer_cls, cfg.learning_rate)
        for epoch in range(1, cfg.num_epochs + 1):
            self.best_train_loss, self.best_eval_loss = self.prepare_train_step(
                epoch, self.best_train_loss, self.best_eval_loss)
            train_loss, train_metrics = self.train_step(epoch)
            eval_loss = eval_metrics = None
            if self.eval_dataset is not None:
                eval_loss, eval_metrics = self.eval_step(epoch)
            self._finalize_epoch(epoch, train_loss, train_metrics, eval_loss,
                                 eval_metrics)
        final_dir = os.path.join(self.training_dir, "final_model")
        self.save_model(final_dir)
        logger.info("Training ended! Saved final model in %s", final_dir)

    def _restore_best(self):
        """Load the kept weights into the model (none kept: keep the live
        ones)."""
        if self._best_state is not None:
            self.model.load_state_dict(self._best_state)

    @property
    def best_model(self):
        """The model with the kept weights loaded."""
        self._restore_best()
        return self.model

    def save_model(self, dir_path: str):
        """Save the best model and the training config."""
        os.makedirs(dir_path, exist_ok=True)
        self.model.save(dir_path, state_dict=self._best_state)
        self.training_config.save_json(dir_path, "training_config")
