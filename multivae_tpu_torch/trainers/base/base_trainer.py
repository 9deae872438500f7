"""Single-device epoch trainer (counterpart of the synchronous loop of
``multivae_tpu/trainers/base/base_trainer.py``).

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
its noise from the step count. A trainer built with ``checkpoint=`` goes
on from epoch N + 1 as the uninterrupted run would.

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

The JAX trainer's fused epoch blocks, pipelined finalization, sharded
(orbax) checkpoints and bfloat16 mode exist to amortize TPU launch costs
or to spread over a TPU mesh and are not part of the port. ``history``
holds each epoch's logged metrics.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import json
import logging
import math
import os
from typing import List, Optional

import numpy as np
import torch

from ...data.batch import batch_from_arrays
from ...data.device_cache import build_device_cache, cache_per_device_nbytes, upload_plan
from ...data.loader import DataLoader
from ...data.prefetch import PrefetchLoader
from ...data.utils import adapt_shape, grid_to_image, make_grid, write_png
from ...models.base.base_ae_model import BaseMultiVAE
from ...models.base.base_model import BaseModel
from ...models.base.step import StepInfo
from ...ops.microbatch import microbatched_backward
from ...utils.device import resolve_device
from .base_trainer_config import BaseTrainerConfig
from .callbacks import (
    CallbackHandler,
    MetricConsolePrinterCallback,
    ProgressBarCallback,
    TrainingCallback,
)
from .optim import make_optimizer, make_scheduler
from .utils import set_seed, update_dict

logger = logging.getLogger(__name__)


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
            absent).

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
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.training_config = training_config
        self.model_config = getattr(model, "model_config", None)
        cfg = training_config

        set_seed(cfg.seed)
        self.train_loader = DataLoader(
            train_dataset, cfg.per_device_train_batch_size, shuffle=True,
            seed=cfg.seed, drop_last=cfg.drop_last)
        self.eval_loader = (
            DataLoader(eval_dataset, cfg.per_device_eval_batch_size,
                       shuffle=False, seed=cfg.seed, drop_last=cfg.drop_last)
            if eval_dataset is not None else None)

        if cfg.microbatch_steps > 1:
            if not getattr(model, "loss_is_sum", False):
                raise AttributeError(
                    "microbatch_steps > 1 requires a SUM-reduction "
                    "objective (chunked gradient accumulation is only "
                    f"exact for batch-sum losses); {type(model).__name__} "
                    "does not declare loss_is_sum = True."
                )
            if cfg.per_device_train_batch_size % cfg.microbatch_steps:
                raise AttributeError(
                    f"global train batch size {cfg.per_device_train_batch_size} "
                    "is not divisible by microbatch_steps="
                    f"{cfg.microbatch_steps}."
                )

        self.optimizer = make_optimizer(cfg.optimizer_cls, model.parameters(),
                                        cfg.learning_rate, cfg.optimizer_params)
        self.scheduler = make_scheduler(cfg.scheduler_cls, self.optimizer,
                                        cfg.scheduler_params)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        self.trained_epochs = 0
        self.best_train_loss = math.inf
        self.best_eval_loss = math.inf
        self._best_state = None
        self.start_keep_best_epoch = getattr(model, "start_keep_best_epoch", 0)
        self.history = []
        self._file_logger = None

        self._train_cache = self._eval_cache = None
        if cfg.cache_on_device:
            budget = int(cfg.device_cache_budget_gb * 1e9)
            layout = cfg.device_cache_layout
            self._train_cache = build_device_cache(train_dataset, self.device, budget,
                                                   layout=layout)
            if self._train_cache is not None:
                # a sampler fitted on this dataset reuses the upload
                train_dataset._sampler_device_cache = self._train_cache
            if eval_dataset is not None:
                # the eval set has a budget of its own: what the train cache
                # leaves, all of it when the train set fell back
                used = (0 if self._train_cache is None
                        else cache_per_device_nbytes(self._train_cache))
                self._eval_cache = build_device_cache(eval_dataset, self.device,
                                                      max(budget - used, 0), layout=layout)
        self._prefetch = {
            "train": PrefetchLoader(self.train_loader, self.device, depth=2),
            "eval": (PrefetchLoader(self.eval_loader, self.device, depth=2)
                     if self.eval_loader is not None else None)}

        self._run_model_sanity_check()

        if checkpoint is not None:
            self._resume_from_checkpoint(checkpoint)

        signature = (str(datetime.datetime.now())[:19]
                     .replace(" ", "_").replace(":", "-"))
        self.training_dir = os.path.join(
            cfg.output_dir,
            f"{getattr(model, 'model_name', type(model).__name__)}"
            f"_training_{signature}")
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

    def _run_model_sanity_check(self):
        """One forward of the loss on the first train batch. It runs under
        ``no_grad`` and draws from a generator of its own, so the training
        generator, and with it every later step's noise, stays put."""
        try:
            batch = next(iter(self.train_loader)).to(self.device)
            generator = torch.Generator(device=self.device).manual_seed(0)
            with torch.no_grad():
                self.model.loss_function(batch, StepInfo(), generator=generator)
        except Exception as e:
            raise ValueError(
                "Error when calling forward on a batch of the training "
                "dataset. Possible reasons: the data input doesn't match "
                "your model's architecture or the model config. Original "
                f"exception: {e}"
            ) from e

    def prepare_train_step(self, epoch, best_train_loss, best_eval_loss):
        """Hook for changes between epochs (the ``MultistageTrainer``'s
        optimizer reset); returns the best train and eval losses to go on
        with."""
        return best_train_loss, best_eval_loss

    # ------------------------------------------------------------- stepping
    def _epoch_batches(self, which: str):
        """The epoch's batches on the device: gathered from the device cache
        by the uploaded plan, or prefetched from the host loader."""
        cache = self._train_cache if which == "train" else self._eval_cache
        if cache is None:
            yield from self._prefetch[which]
            return
        loader = self.train_loader if which == "train" else self.eval_loader
        idx, weights = upload_plan(loader, self.device)
        for i in range(len(idx)):
            yield cache.gather(idx[i], weights[i])

    def _run_epoch(self, loader, epoch: int, generator, train: bool):
        n_batches = len(loader)
        dataset_size = len(loader.dataset)
        n_micro = self.training_config.microbatch_steps
        loss_sum = torch.zeros((), device=self.device)
        metric_sums = {}
        for batch_idx, batch in enumerate(self._epoch_batches("train" if train else "eval")):
            # the eval pass leaves batch_ratio at 0, as the JAX trainer does
            info = StepInfo(epoch=epoch, batch_ratio=batch_idx / n_batches if train else 0.0,
                            dataset_size=dataset_size)
            if train:
                self.optimizer.zero_grad(set_to_none=True)
                out = microbatched_backward(
                    lambda chunk: self.model.loss_function(chunk, info,
                                                           generator=generator),
                    batch, n_micro)
                self.optimizer.step()
                self.callback_handler.on_train_step_end(self.training_config)
            else:
                out = self.model.loss_function(batch, info, generator=generator)
                self.callback_handler.on_eval_step_end(self.training_config)
            loss_sum += out["loss_sum"].detach()
            update_dict(metric_sums, {k: v.detach()
                                      for k, v in out.get("metrics", {}).items()})
        epoch_loss = loss_sum.item() / dataset_size
        metrics = {k: float(v) / n_batches for k, v in metric_sums.items()}
        return epoch_loss, metrics

    def train_step(self, epoch: int):
        """One epoch over the train loader; returns (epoch_loss, metrics)."""
        self.callback_handler.on_train_step_begin(
            self.training_config, train_loader=self.train_loader, epoch=epoch)
        self.model.train()
        self.train_loader.set_epoch(epoch)
        epoch_loss, metrics = self._run_epoch(self.train_loader, epoch,
                                              self.generator, train=True)
        if not math.isfinite(epoch_loss):
            raise ArithmeticError("NaN detected in train loss")
        return epoch_loss, metrics

    def eval_step(self, epoch: int):
        """One epoch over the eval loader (no grad)."""
        self.callback_handler.on_eval_step_begin(
            self.training_config, eval_loader=self.eval_loader, epoch=epoch)
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
        """Scheduler step, best-model tracking, prediction grids,
        checkpoint and logging of one epoch."""
        cfg = self.training_config
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
        elif eval_loss < self.best_eval_loss and not cfg.keep_best_on_train:
            self.best_eval_loss = eval_loss
            self._best_state = self._snapshot()
            logger.info("New best model on eval saved!")
        elif train_loss < self.best_train_loss and cfg.keep_best_on_train:
            self.best_train_loss = train_loss
            self._best_state = self._snapshot()
            logger.info("New best model on train saved!")

        if cfg.steps_predict is not None and (epoch % cfg.steps_predict == 0
                                              or epoch == 1):
            reconstructions = self.predict(epoch)
            self.callback_handler.on_prediction_step(
                cfg, reconstructions=reconstructions, global_step=epoch)
            for key, image in reconstructions.items():
                write_png(os.path.join(self.training_dir, f"recon_from_{key}.png"),
                          image)

        self.callback_handler.on_epoch_end(cfg)

        if cfg.steps_saving is not None and epoch % cfg.steps_saving == 0:
            self.save_checkpoint(dir_path=self.training_dir, epoch=epoch)
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
        logger.info(msg)
        if log_output_dir is not None:
            self._file_logger, handler = self._get_file_logger(log_output_dir)
            self._file_logger.info(msg)
        logger.info("Successfully launched training !\n")
        try:
            for epoch in range(self.trained_epochs + 1, cfg.num_epochs + 1):
                self.callback_handler.on_epoch_begin(
                    cfg, epoch=epoch, train_loader=self.train_loader,
                    eval_loader=self.eval_loader)
                self.best_train_loss, self.best_eval_loss = self.prepare_train_step(
                    epoch, self.best_train_loss, self.best_eval_loss)
                train_loss, train_metrics = self.train_step(epoch)
                eval_loss = eval_metrics = None
                if self.eval_dataset is not None:
                    eval_loss, eval_metrics = self.eval_step(epoch)
                self._finalize_epoch(epoch, train_loss, train_metrics, eval_loss,
                                     eval_metrics)
        finally:
            if self._file_logger is not None:
                # another trainer of this process must not write to this file
                self._file_logger.removeHandler(handler)
                handler.close()
                self._file_logger = None
        final_dir = os.path.join(self.training_dir, "final_model")
        self.save_model(final_dir)
        logger.info("Training ended! Saved final model in %s", final_dir)
        self.callback_handler.on_train_end(cfg)

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
        ones)."""
        if self._best_state is not None:
            self.model.load_state_dict(self._best_state)

    @property
    def best_model(self):
        """The model with the kept weights loaded."""
        self._restore_best()
        return self.model

    @contextlib.contextmanager
    def _with_best_weights(self):
        """The kept weights in the model inside the block, the live ones
        again after it."""
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
        states, the training config and the loop's counters."""
        checkpoint_dir = os.path.join(dir_path, f"checkpoint_epoch_{epoch}")
        os.makedirs(checkpoint_dir, exist_ok=True)
        torch.save(self.optimizer.state_dict(),
                   os.path.join(checkpoint_dir, "optimizer.pt"))
        # The model files hold the kept weights, which are not those
        # training goes on from whenever the loss is not monotonic: the live
        # weights and the generator's state ride beside them, so a resume
        # repeats the uninterrupted run.
        torch.save(self.model.state_dict(),
                   os.path.join(checkpoint_dir, "live_params.pt"))
        torch.save(self.generator.get_state(),
                   os.path.join(checkpoint_dir, "generator.pt"))
        if self.scheduler is not None:
            with open(os.path.join(checkpoint_dir, "scheduler.json"), "w") as f:
                json.dump(self.scheduler.state_dict(), f)
        self.model.save(checkpoint_dir, state_dict=self._best_state)
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
        states and the counters of a checkpoint."""
        with open(os.path.join(checkpoint_dir, "info_checkpoint.json")) as fp:
            info = json.load(fp)
        self.trained_epochs = info["trained_epochs"]
        self.best_train_loss = info["best_train_loss"]
        self.best_eval_loss = info["best_eval_loss"]

        self._best_state = self._load(checkpoint_dir, "model.pt")
        self.model.load_state_dict(self._load(checkpoint_dir, "live_params.pt"))
        self.optimizer.load_state_dict(self._load(checkpoint_dir, "optimizer.pt"))
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
        # without the generator's state the run goes on, from the seed's
        # noise instead of the uninterrupted run's
        gen_path = os.path.join(checkpoint_dir, "generator.pt")
        if os.path.exists(gen_path):
            self.generator.set_state(torch.load(gen_path, weights_only=True))

    # ----------------------------------------------------------- prediction
    @torch.no_grad()
    def predict(self, epoch: int = 0, n_data: int = 8) -> dict:
        """Reconstruction grids of the first ``n_data`` rows of the eval set
        (else the train set) with the kept weights, each an (H, W, 3) uint8
        array: from each modality and from all of them (8 draws each), or
        for a conditional model (CVAE) its main modality from all. The
        draws come from a generator seeded with the training seed."""
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
                with self._with_best_weights():
                    recon = model.predict(batch, cond_mod="all", N=8, flatten=True,
                                          generator=generator)
                grids, _ = adapt_shape({main: plot(recon[main], main),
                                        "true_data": plot(inputs_data[main], main)})
                all_recons["all"] = grid([grids["true_data"], grids[main]])
            return all_recons

        with self._with_best_weights():
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
