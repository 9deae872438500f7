"""Evaluator base class (counterpart of
``multivae_tpu/metrics/base/evaluator_class.py``): the test loader, the
file logger, the optional wandb run and the sampler check.

The test loader keeps the order of the dataset and pads the last batch
with rows of zero weight, which every evaluator leaves out. The
evaluators' draws go through the model's ``draw_noise`` (and the other
draw hooks), from ``generator`` when one is given.
"""

from __future__ import annotations

import datetime
import logging
import os
from pathlib import Path
from typing import Optional

import torch

from ...data.loader import DataLoader


class Evaluator:
    """Base class for metric modules.

    Args:
        model: the model to evaluate.
        test_dataset: dataset for computing the metrics.
        output: folder to save a ``metrics.log`` file (optional).
        eval_config: EvaluatorConfig.
        sampler: optional fitted latent sampler for joint generation.
        generator: generator of the model's draws (its device's RNG when
            None).
    """

    def __init__(self, model, test_dataset, output: str = None, eval_config=None,
                 sampler=None, generator: Optional[torch.Generator] = None):
        from .evaluator_config import EvaluatorConfig

        if eval_config is None:
            eval_config = EvaluatorConfig()
        self.model = model
        self.n_data = len(test_dataset)
        self.batch_size = min(eval_config.batch_size, self.n_data)
        self.test_dataset = test_dataset
        self.eval_config = eval_config
        self.generator = generator
        self.test_loader = DataLoader(test_dataset, self.batch_size, shuffle=False,
                                      drop_last=False)
        if output is not None:
            Path(output).mkdir(parents=True, exist_ok=True)
        self.output = output
        self.set_logger(output)
        self.set_wandb(eval_config.wandb_path)
        self.metrics = {}
        self.sampler = sampler
        if self.sampler is not None and not sampler.is_fitted:
            raise AttributeError(
                "The provided sampler is not fitted. Please fit the sampler "
                "before using it in the evaluator module.")

    def set_logger(self, output):
        evaluator_id = (str(datetime.datetime.now())[0:19].replace(" ", "_")
                        .replace(":", "-"))
        logger = logging.getLogger(evaluator_id)
        logger.setLevel(logging.INFO)
        self.console_handler = logging.StreamHandler()
        logger.addHandler(self.console_handler)
        if output is not None:
            self.file_handler = logging.FileHandler(os.path.join(str(output),
                                                                 "metrics.log"))
            logger.addHandler(self.file_handler)
        self.logger = logger

    def set_wandb(self, wandb_path):
        if wandb_path is None:
            self.wandb_run = None
            return
        try:
            import wandb
        except ImportError as e:
            raise ModuleNotFoundError(
                "You provided a wandb_path, but the `wandb` package is not "
                "installed. Run `pip install wandb`.") from e
        entity, project, run_id = tuple(wandb_path.split("/"))
        self.wandb_run = wandb.init(entity=entity, project=project, id=run_id,
                                    resume="allow", reinit=True)

    def log_to_wandb(self):
        if self.wandb_run is not None:
            self.wandb_run.log(self.metrics)

    def finish(self):
        """Remove the handlers and finish the wandb run."""
        self.logger.removeHandler(self.console_handler)
        if hasattr(self, "file_handler"):
            self.logger.removeHandler(self.file_handler)
            self.file_handler.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()
