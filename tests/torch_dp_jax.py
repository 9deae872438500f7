"""The port's side of ``test_torch_data_parallel.py``'s comparisons with the
JAX trainer at ``n_devices=2``: the model of ``torch_dp_cases``' sizes with
the JAX model's initial weights (a file the test writes), its trainer fed
the JAX trainer's draws through ``torch_parity.feed_trainer_noise``. Each
rank draws the global batch's noise, so the fed draws are the JAX
trainer's own, of which each rank keeps its rows. Imports JAX (its draws)."""

import itertools
import os

import jax
import torch

import torch_dp_cases as cases
from multivae_tpu_torch import models
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import LAPLACE_LOW, feed_trainer_noise, normal, uniform

SEED = 7
# family -> (config fields, incomplete data?, an eval set?, trainer fields)
FED = {
    # a mean loss, padded last batches, Adam and the plateau scheduler on the
    # eval loss
    "MVTCAE": ({}, True, True, dict(optimizer_cls="Adam", **cases.PLATEAU)),
    # DReG: a sum loss, the mixture's plain version on the CPU; SGD with
    # momentum, as MMVAE's DReG gradients leave entries near 0 whose Adam
    # direction float32 noise sets (the one-process MMVAE test compares the
    # losses alone)
    "MMVAE": (dict(K=2), False, False, dict(
        optimizer_cls="SGD", optimizer_params={"momentum": 0.9}, scheduler_cls="StepLR",
        scheduler_params={"step_size": 2, "gamma": 0.5})),
}
COMMON = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=cases.PER_DEVICE,
              per_device_eval_batch_size=cases.PER_DEVICE, seed=SEED)


def draws_of(family):
    """The hook of one loss call's draws from its JAX key: MVTCAE one normal
    draw; MMVAE a Laplace uniform a modality, from the key split over
    them."""
    if family == "MVTCAE":
        return lambda key: (lambda shape, generator=None: normal(key, shape))

    def hook(key):
        keys, calls = jax.random.split(key, len(cases.DIMS)), itertools.count()
        return lambda shape, generator=None: uniform(keys[next(calls)], shape, LAPLACE_LOW, 0.5)
    return hook


def run_fed(name: str, spec: dict, outdir: str) -> dict:
    """Train the port side of ``spec`` (its family and initial weights' file)
    as this rank; save the result, with the weights' checksum before the
    trainer's broadcast."""
    family = spec["family"]
    fields, incomplete, with_eval, extra = FED[family]
    model = getattr(models, family)(getattr(models, family + "Config")(**cases.BASE, **fields),
                                    device="cpu")
    model.load_state_dict(torch.load(spec["init"], weights_only=True))
    digest = cases.state_digest(model)
    train, eval_set = cases.datasets(incomplete, seed=1)
    trainer = BaseTrainer(model, train, eval_set if with_eval else None, device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=os.path.join(outdir, name), **COMMON, **extra))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    steps = feed_trainer_noise(trainer, model, draws_of(family), SEED)
    trainer.train()
    result = dict(cases.result_of(trainer, start), digest=digest, steps=next(steps))
    cases.save(result, outdir, name)
    return result
