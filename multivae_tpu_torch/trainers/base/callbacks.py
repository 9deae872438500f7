"""Training callbacks: the event bus and the built-in callbacks.

Counterpart of ``multivae_tpu/trainers/base/callbacks.py``: the
``TrainingCallback`` events, the ``CallbackHandler`` fan-out, the console
and progress-bar callbacks the trainer always appends, step timing, an
optional wandb callback (``wandb`` imported only there), and
``TorchProfilerCallback`` in place of the JAX package's
``JaxProfilerCallback``.

``ProgressBarCallback`` draws its bars with ``tqdm`` when it can be
imported and draws nothing otherwise: the bars are display only.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)


def wandb_is_available() -> bool:
    return importlib.util.find_spec("wandb") is not None


def load_wandb_path_from_folder(path: str) -> str:
    with open(os.path.join(path, "wandb_info.json")) as fp:
        return json.load(fp)["path"]


def rename_logs(logs: dict) -> dict:
    """train_metric -> train/metric, eval_metric -> eval/metric; other keys
    are dropped."""
    clean = {}
    for name, v in logs.items():
        if name.startswith("train_"):
            clean[name.replace("train_", "train/", 1)] = v
        if name.startswith("eval_"):
            clean[name.replace("eval_", "eval/", 1)] = v
    return clean


class TrainingCallback:
    """Base class of the training callbacks: one method an event."""

    def on_init_end(self, training_config, **kwargs):
        pass

    def on_train_begin(self, training_config, **kwargs):
        pass

    def on_train_end(self, training_config, **kwargs):
        pass

    def on_epoch_begin(self, training_config, **kwargs):
        pass

    def on_epoch_end(self, training_config, **kwargs):
        pass

    def on_train_step_begin(self, training_config, **kwargs):
        pass

    def on_train_step_end(self, training_config, **kwargs):
        pass

    def on_eval_step_begin(self, training_config, **kwargs):
        pass

    def on_eval_step_end(self, training_config, **kwargs):
        pass

    def on_evaluate(self, training_config, **kwargs):
        pass

    def on_prediction_step(self, training_config, **kwargs):
        pass

    def on_save(self, training_config, **kwargs):
        pass

    def on_save_checkpoint(self, training_config, **kwargs):
        pass

    def on_log(self, training_config, logs, **kwargs):
        pass


class CallbackHandler:
    """Dispatches each event to every callback, in order, with the model."""

    def __init__(self, callbacks, model):
        self.callbacks = []
        for cb in callbacks:
            self.add_callback(cb)
        self.model = model

    def add_callback(self, callback):
        cb = callback() if isinstance(callback, type) else callback
        cb_class = callback if isinstance(callback, type) else callback.__class__
        if cb_class in [c.__class__ for c in self.callbacks]:
            logger.warning(
                "You are adding a %s to the callbacks but one is already used. "
                "The current list of callbacks is:\n%s",
                cb_class, self.callback_list,
            )
        self.callbacks.append(cb)

    @property
    def callback_list(self):
        return "\n".join(cb.__class__.__name__ for cb in self.callbacks)

    def call_event(self, event, training_config, **kwargs):
        for callback in self.callbacks:
            getattr(callback, event)(training_config, model=self.model, **kwargs)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(training_config, *args, **kwargs):
                if name == "on_log" and args:
                    kwargs["logs"] = args[0]
                    args = args[1:]
                self.call_event(name, training_config, **kwargs)

            return dispatch
        raise AttributeError(name)


class MetricConsolePrinterCallback(TrainingCallback):
    """Logs the epoch train and eval losses."""

    def __init__(self):
        self.logger = logging.getLogger(__name__)
        self.logger.setLevel(logging.INFO)

    def on_log(self, training_config, logs, **kwargs):
        log = kwargs.pop("logger", self.logger)
        if log is None:
            return
        train_loss = logs.get("train_epoch_loss", None)
        eval_loss = logs.get("eval_epoch_loss", None)
        log.info("-" * 74)
        if train_loss is not None:
            log.info("Train loss: %s", np.round(train_loss, 4))
        if eval_loss is not None:
            log.info("Eval loss: %s", np.round(eval_loss, 4))
        log.info("-" * 74)


def _tqdm():
    """``tqdm.auto.tqdm``, or None where tqdm is not installed."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return None
    return tqdm


class ProgressBarCallback(TrainingCallback):
    """Progress bars over the train and eval steps of an epoch (none where
    tqdm cannot be imported)."""

    def __init__(self):
        self.train_progress_bar = None
        self.eval_progress_bar = None

    def _bar(self, loader, desc):
        tqdm = _tqdm()
        if loader is None or tqdm is None:
            return None
        return tqdm(total=len(loader), unit="batch", desc=desc)

    def on_train_step_begin(self, training_config, **kwargs):
        self.train_progress_bar = self._bar(
            kwargs.get("train_loader"),
            f"Training of epoch {kwargs.get('epoch')}/{training_config.num_epochs}")

    def on_eval_step_begin(self, training_config, **kwargs):
        self.eval_progress_bar = self._bar(
            kwargs.get("eval_loader"),
            f"Eval of epoch {kwargs.get('epoch')}/{training_config.num_epochs}")

    def on_train_step_end(self, training_config, **kwargs):
        if self.train_progress_bar is not None:
            self.train_progress_bar.update(1)

    def on_eval_step_end(self, training_config, **kwargs):
        if self.eval_progress_bar is not None:
            self.eval_progress_bar.update(1)

    def on_epoch_end(self, training_config, **kwargs):
        if self.train_progress_bar is not None:
            self.train_progress_bar.close()
        if self.eval_progress_bar is not None:
            self.eval_progress_bar.close()


class StepTimingCallback(TrainingCallback):
    """Host wall clock of each epoch and its train steps a second, added to
    the logged metrics (``epoch_time_s``, ``train_steps_per_s``). The step
    events fire when a step's work is queued, so on the card an epoch's
    time ends at the loss fetch of its end."""

    def __init__(self):
        self._time = time.perf_counter
        self._epoch_start = None
        self._steps = 0
        self.history = []

    def on_epoch_begin(self, training_config, **kwargs):
        self._epoch_start = self._time()
        self._steps = 0

    def on_train_step_end(self, training_config, **kwargs):
        self._steps += 1

    def on_log(self, training_config, logs, **kwargs):
        if self._epoch_start is None:
            return
        elapsed = self._time() - self._epoch_start
        logs["epoch_time_s"] = elapsed
        if self._steps:
            logs["train_steps_per_s"] = self._steps / elapsed
        self.history.append({"epoch_time_s": elapsed, "steps": self._steps})


class TorchProfilerCallback(TrainingCallback):
    """``torch.profiler`` over the selected epochs, each written as a Chrome
    trace ``trace_epoch_<epoch>.json`` in ``trace_dir`` (CUDA activity too
    when the model is on the card)."""

    def __init__(self, trace_dir: str, epochs=(2,)):
        self.trace_dir = trace_dir
        self.epochs = set(epochs)
        self._profiler = None
        self._epoch = None

    def on_epoch_begin(self, training_config, **kwargs):
        import torch.profiler as tp

        epoch = kwargs.get("epoch")
        if epoch not in self.epochs or self._profiler is not None:
            return
        activities = [tp.ProfilerActivity.CPU]
        model = kwargs.get("model")
        if model is not None and model.device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        self._profiler = tp.profile(activities=activities)
        self._profiler.__enter__()
        self._epoch = epoch

    def on_epoch_end(self, training_config, **kwargs):
        if self._profiler is None:
            return
        self._profiler.__exit__(None, None, None)
        self._profiler.export_chrome_trace(
            os.path.join(self.trace_dir, f"trace_epoch_{self._epoch}.json"))
        self._profiler = None


class WandbCallback(TrainingCallback):
    """Weights & Biases logging; needs the optional ``wandb`` package. Call
    ``setup`` before training, or let ``on_train_begin`` do it."""

    def __init__(self):
        if not wandb_is_available():
            raise ModuleNotFoundError(
                "`wandb` package must be installed. Run `pip install wandb`"
            )
        import wandb

        self._wandb = wandb
        self.is_initialized = False

    def setup(self, training_config, model_config=None,
              project_name="multivae_tpu", entity_name=None, run_id=None,
              **kwargs):
        self.is_initialized = True
        if run_id is not None:
            self.run = self._wandb.init(
                project=project_name, entity=entity_name, id=run_id,
                resume="must",
            )
        else:
            self.run = self._wandb.init(project=project_name, entity=entity_name)
        self.run.config.update({"training_config": training_config.to_dict()})
        if model_config is not None:
            self.run.config.update({"model_config": model_config.to_dict()})

    def on_train_begin(self, training_config, **kwargs):
        model_config = kwargs.pop("model_config", None)
        if not self.is_initialized:
            self.setup(training_config, model_config=model_config)

    def on_log(self, training_config, logs, **kwargs):
        global_step = kwargs.pop("global_step", None)
        logs = rename_logs(logs)
        self._wandb.log({**logs, "train/global_step": global_step})

    def on_prediction_step(self, training_config, **kwargs):
        global_step = kwargs.pop("global_step", None)
        reconstructions = kwargs.pop("reconstructions", None)
        if reconstructions is not None:
            images = {
                f"recon_from_{k}": self._wandb.Image(v)
                for k, v in reconstructions.items()
            }
            self._wandb.log({**images, "train/global_step": global_step})

    def on_save_checkpoint(self, training_config, **kwargs):
        checkpoint_dir = kwargs.pop("checkpoint_dir", None)
        if checkpoint_dir is not None:
            info = {"path": f"{self.run.entity}/{self.run.project}/{self.run.id}"}
            with open(os.path.join(checkpoint_dir, "wandb_info.json"), "w") as fp:
                json.dump(info, fp)

    def on_train_end(self, training_config, **kwargs):
        self.run.finish()
