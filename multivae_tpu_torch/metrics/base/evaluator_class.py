"""Evaluator base class (counterpart of
``multivae_tpu/metrics/base/evaluator_class.py``): the test loader, the
file logger, the optional wandb run and the sampler check.

The test loader keeps the order of the dataset and pads the last batch
with rows of zero weight, which every evaluator leaves out. With
``cache_on_device`` (the default) it gathers the batches from a copy of
the test set on the model's device (``DeviceCachedLoader``); otherwise, or
where that cache falls back, a ``PrefetchLoader`` thread reads them from
the host ahead of use. Either way a batch's data and masks are on the
model's device and its weights and labels on the host. The
evaluators' draws go through the model's ``draw_noise`` (and the other
draw hooks), from ``generator`` when one is given.

With ``n_devices`` > 1 (or a process group of one) the evaluation is data
parallel, as the JAX evaluator shards its batches over a device mesh
(``n_devices`` = 1 in a larger group: each process evaluates alone, as
the JAX evaluator's one device does):
each of the group's processes takes its columns of every test batch (the
loader's ``process_columns``), the model's draws on a batch are the
global batch's with this process's rows kept (``model.data_shard``, under
``on_ranks()``), and each evaluator sums its counts and sums over the
group (``sum_over_ranks``) or gathers its embeddings (``gather_valid``)
before the host's last step. Draws that do not follow the batch (the
prior's, a sampler's, the grids') are made alike by every process from a
generator in the same state. So every process returns what one process
returns on the same batches, up to the order of the sums. The test-set
cache follows the trainer's layout rules over the group (replicated, or
row-sharded when only that fits the budget). Only rank 0 logs, writes
``metrics.log`` and the grids, and logs to wandb.
"""

from __future__ import annotations

import datetime
import logging
import os
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from ...data.device_cache import DeviceCachedLoader, build_device_cache
from ...data.loader import DataLoader
from ...data.prefetch import PrefetchLoader
from ...parallel.mesh import DataMesh, get_data_mesh
from ...parallel.shard import NO_SHARD, DataShard


class Evaluator:
    """Base class for metric modules.

    Args:
        model: the model to evaluate.
        test_dataset: dataset for computing the metrics.
        output: folder to save a ``metrics.log`` file (optional).
        eval_config: EvaluatorConfig.
        sampler: optional fitted latent sampler for joint generation.
        generator: generator of the model's draws (its device's RNG when
            None); over a process group, every process's in the same state.
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
        self.n_devices = eval_config.n_devices
        if self.n_devices == 1 and dist.is_initialized() and dist.get_world_size() > 1:
            self.mesh = DataMesh(1, 0, 0, torch.device(model.device), False)
        else:
            self.mesh = get_data_mesh(self.n_devices, model.device)
        self.is_main_process = self.mesh.is_main_process
        world = self.mesh.world_size
        self.shard = (DataShard(self.mesh.rank, world, distributed=True)
                      if self.mesh.distributed else NO_SHARD)
        if self.batch_size % world:
            # JAX: padding rows of zero weight, so that the columns divide
            self.batch_size += world - self.batch_size % world
        loader = DataLoader(test_dataset, self.batch_size, shuffle=False, drop_last=False,
                            num_processes=world, process_index=self.mesh.rank)
        cache = None
        if eval_config.cache_on_device:
            cache = build_device_cache(test_dataset, model.device,
                                       int(eval_config.device_cache_budget_gb * 1e9),
                                       mesh=self.mesh)
        self.test_loader = (DeviceCachedLoader(loader, cache) if cache is not None else
                            PrefetchLoader(loader, model.device, depth=2,
                                           host_fields=("weights", "labels")))
        if not self.is_main_process:
            output = None
        if output is not None:
            Path(output).mkdir(parents=True, exist_ok=True)
        self.output = output
        self.set_logger(output)
        self.set_wandb(eval_config.wandb_path if self.is_main_process else None)
        self.metrics = {}
        self.sampler = sampler
        if self.sampler is not None and not sampler.is_fitted:
            raise AttributeError(
                "The provided sampler is not fitted. Please fit the sampler "
                "before using it in the evaluator module.")

    # ------------------------------------------------------- data parallel
    def on_ranks(self):
        """The block in which the model's draws on a batch are the global
        batch's, this process's rows kept (nothing without a group)."""
        return self.model.sharded(self.shard if self.shard.distributed else None)

    def sum_over_ranks(self, values: List[float]) -> List[float]:
        """``values`` summed over the group, in float64 (as they are
        without one)."""
        if not self.shard.distributed:
            return list(values)
        vec = torch.tensor(values, dtype=torch.float64, device=self.mesh.device)
        torch.distributed.all_reduce(vec)
        return vec.tolist()

    def gather_valid(self, t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The global batch's real rows of ``t``, in order, on every process:
        ``t`` holds one row for each real row of this process's columns
        (``valid``: their (b,) mask)."""
        if not self.shard.distributed:
            return t
        device = self.mesh.device
        full = t.new_zeros((valid.shape[0], *t.shape[1:]), device=device)
        full[valid.to(device)] = t.to(device)
        rows = self.shard.gather(full)
        return rows[self.shard.gather(valid.to(device))].to(t.device)

    def set_logger(self, output):
        evaluator_id = (str(datetime.datetime.now())[0:19].replace(" ", "_")
                        .replace(":", "-"))
        logger = logging.getLogger(evaluator_id)
        logger.setLevel(logging.INFO)
        self.console_handler = (logging.StreamHandler() if self.is_main_process
                                else logging.NullHandler())
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
