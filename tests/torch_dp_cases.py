"""The cases of ``test_torch_data_parallel.py``, importing no JAX, so that its
worker processes (``torch_dp_worker.py``) and the test process build the
same runs: each case is a tiny model of one family (three modalities of 3, 4
and 2 features, latent 4, default nets; MHVAE on the MLP test blocks), its
datasets made from a seed and its trainer config. ``run_case`` trains it in
one process or as one rank of the process group that exists, at
``PER_DEVICE`` rows a device, and saves what the test compares.

37 train rows in global batches of 16 leave a last batch of 5 rows and 11
padding rows: under two ranks, rank 0 holds the 5 rows and 3 padding rows,
rank 1 only padding. The eval set's 21 rows do the same."""

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from multivae_tpu_torch import models
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig, MultistageTrainer
from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback
from torch_nets import mhvae_mlp_blocks

DIMS = {"a": (3,), "b": (4,), "c": (2,)}
BASE = dict(n_modalities=3, latent_dim=4, input_dims=DIMS)
N_TRAIN, N_EVAL, PER_DEVICE, EPOCHS, LR = 37, 21, 8, 2, 1e-2

# family -> (config fields, incomplete data?)
FAMILIES = {
    "MMVAE": (dict(K=2), True),
    "MMVAEPlus": (dict(K=2, modalities_specific_dim=2), True),
    "CMVAE": (dict(modalities_specific_dim=2, number_of_clusters=3), False),
    "MVTCAE": ({}, True),
    "MVAE": (dict(k=1), True),
    "MoPoE": ({}, True),
    "CRMVAE": ({}, True),
    "DMVAE": (dict(modalities_specific_dim={"a": 1, "b": 2, "c": 1}), True),
    "JMVAE": (dict(warmup=1), False),
    "TELBO": (dict(warmup=1), False),
    "JNF": (dict(warmup=1), False),
    "CVAE": (None, False),
    "MHVAE": (dict(n_latent=3), True),
    "Nexus": (dict(modalities_specific_dim={"a": 2, "b": 2, "c": 2}, msg_dim=3,
                   warmup=2, adapt_top_decoder_variance=["a"]), False),
}
# the 14 families, then variants that take other paths: MoPoE's index-range
# split of a complete batch, MMVAE's microbatched step, the device cache
CASES = {**{name: dict(family=name) for name in FAMILIES},
         "MoPoE_complete": dict(family="MoPoE", incomplete=False),
         "MMVAE_microbatch": dict(family="MMVAE", trainer=dict(microbatch_steps=2)),
         "MVTCAE_cached": dict(family="MVTCAE", trainer=dict(cache_on_device=True))}
# SGD with momentum: its moves are linear in the gradients, so two runs'
# weights differ by their gradients' float32 summation order and no more.
# (Adam divides each gradient by its running RMS: where that is ~0 the
# direction is noise, which the test against the JAX trainer allows for.)
OPTIMIZER = dict(optimizer_cls="SGD", optimizer_params={"momentum": 0.9})
# MVTCAE's plateau scheduler halves the rate after an epoch whose eval loss
# does not fall 10% below the best (epoch 2's falls 3%)
PLATEAU = dict(scheduler_cls="ReduceLROnPlateau",
               scheduler_params={"mode": "min", "patience": 0, "factor": 0.5,
                                 "threshold": 0.1})


def model_of(family: str):
    """The family's tiny model, its weights from the family's seed."""
    torch.manual_seed(0)
    cls, config_cls = getattr(models, family), getattr(models, family + "Config")
    if family == "CVAE":
        return cls(config_cls(main_modality="a", conditioning_modalities=["b", "c"],
                              input_dims=DIMS, latent_dim=4), device="cpu")
    config = config_cls(**BASE, **FAMILIES[family][0])
    if family == "MHVAE":
        names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
                 "posterior_blocks", "prior_blocks")
        return cls(config, **dict(zip(names, mhvae_mlp_blocks(DIMS, 4))), device="cpu")
    return cls(config, device="cpu")


def arrays(incomplete: bool, seed: int = 0):
    """[(data, masks)] of the train set's ``N_TRAIN`` rows and the eval set's
    ``N_EVAL``; on incomplete data each (row, modality) is missing with
    probability 0.3 and the first train row has no modality (masks None on
    complete data)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (N_TRAIN, N_EVAL):
        data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}
        masks = None
        if incomplete:
            masks = {m: rng.uniform(size=n) > 0.3 for m in DIMS}
            for m in DIMS:
                masks[m][0] = False
                data[m][~masks[m]] = 0.0
        out.append((data, masks))
    return out


def datasets(incomplete: bool, seed: int = 0):
    """The (train, eval) datasets of ``arrays``."""
    return [MultimodalBaseDataset(data) if masks is None else IncompleteDataset(data, masks)
            for data, masks in arrays(incomplete, seed)]


def trainer_of(case: str, output_dir: str, checkpoint=None, **overrides):
    """The case's trainer on the CPU, at ``PER_DEVICE`` rows a device."""
    spec = CASES[case]
    family = spec["family"]
    incomplete = spec.get("incomplete", FAMILIES[family][1])
    model = model_of(family)
    train, eval_set = datasets(incomplete)
    kwargs = dict(output_dir=output_dir, num_epochs=EPOCHS, learning_rate=LR,
                  per_device_train_batch_size=PER_DEVICE,
                  per_device_eval_batch_size=PER_DEVICE, seed=5, **OPTIMIZER)
    if family == "MVTCAE":
        kwargs.update(PLATEAU)
    kwargs.update(spec.get("trainer", {}))
    kwargs.update(overrides)
    cls = MultistageTrainer if getattr(model, "reset_optimizer_epochs", None) else BaseTrainer
    return cls(model, train, eval_set, training_config=BaseTrainerConfig(**kwargs),
               checkpoint=checkpoint, device="cpu")


def state_digest(model) -> float:
    """A float64 checksum of the weights (replicas' equality at a glance)."""
    return math.fsum(float(p.double().sum()) for p in model.state_dict().values())


def result_of(trainer, start: dict) -> dict:
    """What the test compares: the logged history, the start, live and kept
    weights, the optimizer's momentum buffers and its rates after
    training."""
    names = {p: k for k, p in trainer.model.named_parameters()}
    return dict(history=trainer.history, start=start,
                live={k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
                best=trainer._best_state,
                momentum={names[p]: s["momentum_buffer"].clone()
                          for p, s in trainer.optimizer.state.items()
                          if s.get("momentum_buffer") is not None},
                lrs=[float(g["lr"]) for g in trainer.optimizer.param_groups],
                world=trainer.mesh.world_size)


def save(result: dict, outdir: str, name: str):
    """``<name>_rank<r>.pt`` in ``outdir``, written whole or not at all (the
    test reads it while the workers go on)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(outdir, f"{name}_rank{rank}.pt")
    torch.save(result, path + ".part")
    os.replace(path + ".part", path)


def load(outdir: str, name: str, rank: int) -> dict:
    return torch.load(os.path.join(outdir, f"{name}_rank{rank}.pt"), weights_only=False)


def run_case(case: str, outdir: str, **overrides) -> dict:
    """Train ``case`` (alone, or as this rank of the process group) and
    save its result as ``<case>_rank<r>.pt`` in ``outdir``."""
    trainer = trainer_of(case, os.path.join(outdir, case), **overrides)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train()
    result = result_of(trainer, start)
    save(result, outdir, case)
    return result


class EventCounter(TrainingCallback):
    """How often the writing events and ``on_log`` fired on this rank."""

    def __init__(self):
        self.counts = {"on_save": 0, "on_save_checkpoint": 0, "on_prediction_step": 0,
                       "on_log": 0}

    def on_save(self, training_config, **kwargs):
        self.counts["on_save"] += 1

    def on_save_checkpoint(self, training_config, **kwargs):
        self.counts["on_save_checkpoint"] += 1

    def on_prediction_step(self, training_config, **kwargs):
        self.counts["on_prediction_step"] += 1

    def on_log(self, training_config, logs, **kwargs):
        self.counts["on_log"] += 1


def resume_case(outdir: str) -> dict:
    """MVTCAE for 3 epochs with a checkpoint and the grids every epoch, then
    a run resumed from its ``checkpoint_epoch_2``: both results, the events
    each rank fired and the files the runs left."""
    events = EventCounter()
    full = trainer_of("MVTCAE", os.path.join(outdir, "resume_full"), num_epochs=3,
                      steps_saving=1, steps_predict=1)
    full.callback_handler.add_callback(events)
    start = {k: v.clone() for k, v in full.model.state_dict().items()}
    full.train()
    checkpoint = os.path.join(full.training_dir, "checkpoint_epoch_2")
    resumed = trainer_of("MVTCAE", os.path.join(outdir, "resume_part"), num_epochs=3,
                         checkpoint=checkpoint)
    resumed.train()
    result = dict(full=result_of(full, start), resumed=result_of(resumed, start),
                  events=events.counts, files=sorted(os.listdir(full.training_dir)))
    save(result, outdir, "resume")
    return result


def refusal_case(outdir: str) -> dict:
    """The messages of the refusals under the process group (None where the
    trainer was built): a mismatched ``n_devices``, ``steps_per_execution``
    > 1 and the sharded cache."""
    messages = {}
    for name, kwargs in (("n_devices", dict(n_devices=3)),
                         ("steps_per_execution", dict(cache_on_device=True,
                                                      steps_per_execution=2)),
                         ("sharded", dict(cache_on_device=True,
                                          device_cache_layout="sharded"))):
        try:
            trainer_of("MVTCAE", os.path.join(outdir, "refused"), **kwargs)
            messages[name] = None
        except (ValueError, NotImplementedError) as e:
            messages[name] = f"{type(e).__name__}: {e}"
    save(messages, outdir, "refusals")
    return messages


def reducer_case(outdir: str) -> dict:
    """The gradient all-reduce where gradients are None on some ranks only:
    three weights of 3 entries, ``a`` in every rank's loss, ``b`` in rank
    0's only, ``c`` in none, reduced by the trainer's reducer of a
    replicated run (the whole state of a module holding them). Saves each
    rank's gradients after the reducer (None where absent) and the bytes it
    reduced."""
    from multivae_tpu_torch.parallel import ShardedState, get_data_mesh

    rank = dist.get_rank()
    module = torch.nn.Module()
    for i, name in enumerate("abc"):
        module.register_parameter(name, torch.nn.Parameter(torch.arange(3.0) + i))
    a, b, c = module.a, module.b, module.c
    reducer = ShardedState(module, get_data_mesh(None, "cpu"), fsdp=False)
    assert not reducer.cuts and all(m is p for m, p in zip(reducer.masters(), (a, b, c)))
    loss = (a * (rank + 1)).sum() + ((b ** 2).sum() if rank == 0 else 0.0)
    loss.backward()
    reducer()
    result = dict(grads=[None if p.grad is None else p.grad.clone() for p in (a, b, c)],
                  bytes=reducer.bytes_reduced)
    save(result, outdir, "reducer")
    return result
