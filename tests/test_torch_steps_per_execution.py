"""The port's ``steps_per_execution`` and pipelined finalization against the
JAX trainer's, on the CPU at a small size.

- MVAE (3 modalities on the MLP nets of ``test_torch_mvae.py``, warm-up 2,
  one random subset a step, so ``batch_ratio`` sets the KL weight) trained 3
  epochs on 20 cached incomplete rows in batches of 4 (5 steps an epoch,
  which 3 does not divide) with an 8-row eval set, by the JAX trainer and
  by the port at ``steps_per_execution`` 1, 3 and 8, the JAX trainer's
  draws fed to the port (``torch_parity.feed_trainer_noise``): the epoch
  losses, metrics and kept weights against the JAX run's, and the port's
  three runs against each other bit for bit (on the CPU a chunk runs the
  steps eagerly, with the step scalars as float32 tensors).
- ``pipeline_epochs`` on and off: TELBO through the ``MultistageTrainer``
  (reset at epoch 2, stage flip at 3) with a StepLR, a checkpoint at epoch
  4 and a window of 3, on the host path and on the chunked one: the same
  history, kept weights, live weights and checkpoint, with the epochs that
  may lag finalized late and the others at once; and MVAE's kept weights
  with the eval loss tracked, the train loss, a keep-best warm-up and
  nothing, from the window's one candidate copy, bit for bit.
- ``OptaxRule`` with its step count as a tensor (``make_capturable``)
  against the numbers it takes otherwise.
- MVAE's, JMVAE's and Nexus's warm-ups with tensor step scalars against
  floats, bit for bit.
- The config's checks against the JAX config's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import JMVAE, MVAE, TELBO, JMVAEConfig, MVAEConfig, Nexus
from multivae_tpu_torch.models import NexusConfig, TELBOConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig, MultistageTrainer
from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.trainers.base.optim import make_capturable, make_optimizer
from test_torch_mvae import DIMS, SEED, _arrays, _JaxDraws, _models
from torch_parity import Recorder, assert_same_moves, feed_trainer_noise, state_of

torch.set_num_threads(2)

N_ROWS, N_EVAL, BATCH, EPOCHS = 20, 8, 4, 3
COMMON = dict(num_epochs=EPOCHS, learning_rate=1e-3, per_device_train_batch_size=BATCH,
              per_device_eval_batch_size=BATCH, seed=SEED, optimizer_cls="Adam",
              cache_on_device=True)
# float32 drift over 15 Adam steps of two implementations (as
# test_torch_mvae.py's trainer curve)
CURVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer at ``steps_per_execution=3`` (its chunked cached
    path): its logged epochs, kept weights and the starting weights."""
    tmp = tmp_path_factory.mktemp("spe")
    data, masks, _ = _arrays(True, seed=5, n=N_ROWS)
    eval_data, _, _ = _arrays(False, seed=6, n=N_EVAL)
    jmodel, tmodel = _models(k=1, warmup=2)
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JIncompleteDataset(data, masks), JDataset(eval_data),
                        training_config=JTrainerConfig(
                            output_dir=str(tmp / "jax"), n_devices=1, steps_per_execution=3,
                            pipeline_epochs=False, **COMMON),
                        callbacks=[rec])
    jtrainer.train()
    return dict(logs=rec.logs, best=state_of(jtrainer.best_params),
                start={k: v.clone() for k, v in tmodel.state_dict().items()},
                data=data, masks=masks, eval_data=eval_data, tmp=tmp)


def _mvae_draws(trainer, model):
    """The JAX trainer's MVAE draws (noise and random subsets) fed to the
    port's trainer."""
    current = {}

    def draws_of_key(key):
        current["draws"] = _JaxDraws(key, 1)
        return lambda shape, generator=None: current["draws"].noise(shape)

    model.draw_subsets = lambda n, k, generator=None: current["draws"].subsets(n, k)
    return feed_trainer_noise(trainer, model, draws_of_key, SEED)


@pytest.fixture(scope="module")
def port_runs(jax_run):
    """The port at ``steps_per_execution`` 1, 3 and 8 (more than the 5
    batches) on the JAX run's weights, data and draws."""
    runs = {}
    for n in (1, 3, 8):
        _, tmodel = _models(k=1, warmup=2)
        tmodel.load_state_dict(jax_run["start"])
        trainer = BaseTrainer(
            tmodel, IncompleteDataset(jax_run["data"], jax_run["masks"]),
            MultimodalBaseDataset(jax_run["eval_data"]), device="cpu",
            training_config=BaseTrainerConfig(output_dir=str(jax_run["tmp"] / f"port{n}"),
                                              steps_per_execution=n, **COMMON))
        steps = _mvae_draws(trainer, tmodel)
        trainer.train()
        runs[n] = dict(trainer=trainer, steps=next(steps),
                       live={k: v.clone() for k, v in tmodel.state_dict().items()})
    return runs


@pytest.mark.parametrize("n", [1, 3, 8])
def test_port_at_steps_per_execution_matches_the_jax_trainer(jax_run, port_runs, n):
    """Epoch losses and every metric within ``CURVE_RTOL`` of the JAX
    trainer's, the kept weights' moves within ``assert_same_moves``; the
    MVAE warm-up (``beta``) follows ``batch_ratio`` in both."""
    run = port_runs[n]
    trainer = run["trainer"]
    assert run["steps"] == EPOCHS * 5
    assert len(trainer.history) == len(jax_run["logs"]) == EPOCHS
    for ours, ref in zip(trainer.history, jax_run["logs"]):
        assert set(ours) == set(ref)
        for key, v in ref.items():
            np.testing.assert_allclose(ours[key], v, rtol=CURVE_RTOL, atol=1e-5, err_msg=key)
    # the mean beta of epoch 1: the warm-up by batch, (0 + 1/5 + ... + 4/5) / 2 / 5 * 2.5
    np.testing.assert_allclose(trainer.history[0]["train_beta"], 0.5, rtol=1e-6)
    assert_same_moves(trainer._best_state, jax_run["best"], jax_run["start"], 1e-3)


def test_chunked_runs_equal_the_step_by_step_run(port_runs):
    """On the CPU a chunk runs its steps eagerly: the chunked runs give the
    step-by-step run's history, kept and live weights bit for bit."""
    ref = port_runs[1]
    for n in (3, 8):
        run = port_runs[n]
        assert run["trainer"].history == ref["trainer"].history
        for k, v in ref["live"].items():
            assert torch.equal(run["live"][k], v), k
            assert torch.equal(run["trainer"]._best_state[k], ref["trainer"]._best_state[k]), k


# ----------------------------------------------------------- pipelining
TELBO_DIMS = {"m0": (4,), "m1": (6,)}


class _Order(TrainingCallback):
    """The epoch each log came after: the number of train passes begun."""

    def __init__(self):
        self.begun, self.logged_after = 0, []

    def on_train_step_begin(self, training_config, **kwargs):
        self.begun += 1

    def on_log(self, training_config, logs, **kwargs):
        self.logged_after.append(self.begun)


def _telbo_run(tmp_path, pipeline, cache, steps):
    torch.manual_seed(0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=4) for m, d in TELBO_DIMS.items()}
    model = TELBO(TELBOConfig(n_modalities=2, latent_dim=4, input_dims=TELBO_DIMS, warmup=2),
                  encoders={m: Encoder_VAE_MLP(c, hidden_dim=8) for m, c in cfg.items()},
                  decoders={m: Decoder_AE_MLP(c, hidden_dim=8) for m, c in cfg.items()},
                  device="cpu")
    rng = np.random.default_rng(0)
    data = {m: rng.random((10, *d), dtype=np.float32) for m, d in TELBO_DIMS.items()}
    evald = {m: rng.random((6, *d), dtype=np.float32) for m, d in TELBO_DIMS.items()}
    order = _Order()
    trainer = MultistageTrainer(
        model, MultimodalBaseDataset(data), MultimodalBaseDataset(evald), device="cpu",
        callbacks=[order], training_config=BaseTrainerConfig(
            output_dir=str(tmp_path), num_epochs=7, per_device_train_batch_size=4,
            per_device_eval_batch_size=4, learning_rate=1e-2, steps_saving=4,
            scheduler_cls="StepLR", scheduler_params={"step_size": 2, "gamma": 0.5},
            pipeline_epochs=pipeline, pipeline_depth=3, cache_on_device=cache,
            steps_per_execution=steps, seed=3))
    trainer.train()
    return trainer, order


@pytest.mark.parametrize("cache,steps", [(False, 1), (True, 2)])
def test_pipelined_epochs_log_what_the_synchronous_loop_logs(tmp_path, cache, steps):
    """The same history, kept and live weights and checkpoint of epoch 4;
    the epochs finalized as the JAX loop does: at once before a boundary
    (epochs 1 and 2, before the reset at 2 and the flip at 3), at a
    checkpoint (4) and at the last epoch (7), the others with the next of
    these (3 with 4; 5 and 6 with 7)."""
    sync, sync_order = _telbo_run(tmp_path / "sync", False, cache, steps)
    piped, piped_order = _telbo_run(tmp_path / "piped", True, cache, steps)
    assert not sync._pipeline_epochs_eligible() and piped._pipeline_epochs_eligible()
    assert piped._prepare_boundaries() == {2, 3}
    assert piped.history == sync.history
    for k, v in sync._best_state.items():
        assert torch.equal(piped._best_state[k], v), k
    for k, v in sync.model.state_dict().items():
        assert torch.equal(piped.model.state_dict()[k], v), k
    for name in ("live_params.pt", "model.pt", "optimizer.pt"):
        a, b = (torch.load(os.path.join(t.training_dir, "checkpoint_epoch_4", name),
                           weights_only=True) for t in (sync, piped))
        assert repr(a) == repr(b), name
    with open(os.path.join(sync.training_dir, "checkpoint_epoch_4", "scheduler.json")) as f:
        sched = json.load(f)
    with open(os.path.join(piped.training_dir, "checkpoint_epoch_4", "scheduler.json")) as f:
        assert json.load(f) == sched
    # the train passes begun when each epoch was logged
    assert sync_order.logged_after == [1, 2, 3, 4, 5, 6, 7]
    assert piped_order.logged_after == [1, 2, 4, 4, 7, 7, 7]


def _tracked_run(tmp_path, pipeline, case, lr):
    """MVAE on 12 rows (3 steps an epoch), 8 epochs, a window of 3: the
    eval loss tracked, the train loss (``keep_best_on_train``, no eval
    set), a keep-best warm-up of 4 epochs, or nothing tracked."""
    torch.manual_seed(1)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=4) for m, d in DIMS.items()}
    model = MVAE(MVAEConfig(n_modalities=len(DIMS), latent_dim=4, input_dims=DIMS),
                 encoders={m: Encoder_VAE_MLP(c, hidden_dim=8) for m, c in cfg.items()},
                 decoders={m: Decoder_AE_MLP(c, hidden_dim=8) for m, c in cfg.items()},
                 device="cpu")
    model.start_keep_best_epoch = 4 if case == "warmup" else 0   # MVAE's: its warm-up
    rng = np.random.default_rng(2)
    data = {m: rng.random((12, *d), dtype=np.float32) for m, d in DIMS.items()}
    evald = ({m: rng.random((6, *d), dtype=np.float32) for m, d in DIMS.items()}
             if case in ("eval", "warmup") else None)
    trainer = BaseTrainer(
        model, MultimodalBaseDataset(data), evald and MultimodalBaseDataset(evald),
        device="cpu", training_config=BaseTrainerConfig(
            output_dir=str(tmp_path), num_epochs=8, per_device_train_batch_size=4,
            per_device_eval_batch_size=4, learning_rate=lr, seed=3,
            keep_best_on_train=case == "train", pipeline_epochs=pipeline, pipeline_depth=3))
    trainer.train()
    return trainer


@pytest.mark.parametrize("case,lr", [("eval", 0.05), ("train", 0.05), ("warmup", 0.05),
                                     ("none", 1e-3)])
def test_pipelined_windows_keep_the_synchronous_loops_best(tmp_path, case, lr):
    """Pipelined best-model tracking keeps the synchronous loop's weights
    bit for bit from its one candidate buffer on the device, where the
    tracked loss both improves and does not within a window (the learning
    rate of 0.05 makes it rise now and then), and allocates none where
    nothing can be kept."""
    sync = _tracked_run(tmp_path / "sync", False, case, lr)
    piped = _tracked_run(tmp_path / "piped", True, case, lr)
    assert piped._pipeline_epochs_eligible()
    assert piped.history == sync.history
    if case == "none":
        assert sync._best_state is piped._best_state is piped._candidate["state"] is None
        return
    for k, v in sync._best_state.items():
        assert torch.equal(piped._best_state[k], v), k
    key = "train_epoch_loss" if case == "train" else "eval_epoch_loss"
    losses = [h[key] for h in sync.history][4 if case == "warmup" else 0:]
    rises = [b >= a for a, b in zip(losses, losses[1:])]
    assert any(rises) and not all(rises), losses


# ----------------------------------------------------------- optimizers
@pytest.mark.parametrize("name,params", [
    ("Adam", {"amsgrad": True}), ("Adam", {"nesterov": True, "eps_root": 1e-8}),
    ("RAdam", {"threshold": 4.0}), ("Adagrad", {"lr_decay": 0.1}),
    ("RMSprop", {"momentum": 0.9, "centered": True})])
def test_optax_rule_with_a_tensor_step_count(name, params):
    """The capturable form (step counts and the rate as 0-d tensors, the
    bias corrections tensor ops in float32) against the numeric one (its
    bias corrections in float64 on the host): 6 steps of the same
    gradients, the learning rate cut to a tenth by hand after 3. The
    corrections' float32 rounding moves an update by ~1e-7 of itself, which
    can turn the rounding of a weight's sum: within 4 ulps of the largest
    weight."""
    rng = np.random.default_rng(1)
    init = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((5, 3), (3,))]
    grads = [[torch.tensor(rng.normal(size=p.shape), dtype=torch.float32) for p in init]
             for _ in range(6)]
    finals = []
    for capturable in (False, True):
        ps = [p.clone().requires_grad_() for p in init]
        opt = make_optimizer(name, ps, 1e-2, dict(params))
        if capturable:
            make_capturable(opt)
            assert all(isinstance(g["lr"], torch.Tensor) for g in opt.param_groups)
        for i, gs in enumerate(grads):
            if i == 3:
                for g in opt.param_groups:
                    if isinstance(g["lr"], torch.Tensor):
                        g["lr"].fill_(1e-3)
                    else:
                        g["lr"] = 1e-3
            for p, g in zip(ps, gs):
                p.grad = g.clone()
            opt.step()
        if capturable:
            assert all(isinstance(s["step"], torch.Tensor) and float(s["step"]) == 6
                       for s in opt.state.values())
        finals.append([p.detach() for p in ps])
    for a, b in zip(*finals):
        ulp = torch.finfo(torch.float32).eps * float(a.abs().max())
        torch.testing.assert_close(b, a, rtol=0, atol=4 * ulp)


# ------------------------------------------------------------ step scalars
def _warmup_models():
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=4) for m, d in DIMS.items()}
    enc = {m: Encoder_VAE_MLP(c, hidden_dim=8) for m, c in cfg.items()}
    dec = {m: Decoder_AE_MLP(c, hidden_dim=8) for m, c in cfg.items()}
    common = dict(n_modalities=len(DIMS), latent_dim=4, input_dims=DIMS)
    return {"MVAE": MVAE(MVAEConfig(**common, warmup=3, k=1), encoders=enc, decoders=dec,
                         device="cpu"),
            "JMVAE": JMVAE(JMVAEConfig(**common, warmup=3), encoders=enc, decoders=dec,
                           device="cpu"),
            "Nexus": Nexus(NexusConfig(**common, warmup=3, msg_dim=4,
                                       modalities_specific_dim={m: 3 for m in DIMS}),
                           device="cpu")}


@pytest.mark.parametrize("family", ["MVAE", "JMVAE", "Nexus"])
def test_warmups_take_tensor_step_scalars(family):
    """Each warm-up in float32 tensor ops: 0-d float32 tensors give what
    the numbers give, bit for bit, inside and past the warm-up."""
    model = _warmup_models()[family]
    rng = np.random.default_rng(2)
    batch = batch_from_arrays({m: rng.random((6, *d), dtype=np.float32)
                               for m, d in DIMS.items()})
    for epoch, ratio in ((1, 0.0), (2, 0.4), (3, 0.6), (5, 0.2)):
        outs = []
        for step in (StepInfo(epoch=float(epoch), batch_ratio=ratio, dataset_size=6.0),
                     StepInfo(epoch=torch.tensor(float(epoch)),
                              batch_ratio=torch.tensor(ratio, dtype=torch.float32),
                              dataset_size=6.0)):
            with torch.no_grad():
                outs.append(model.loss_function(batch, step,
                                                generator=torch.Generator().manual_seed(0)))
        assert torch.equal(outs[0]["loss"], outs[1]["loss"]), (family, epoch)
        for k, v in outs[0]["metrics"].items():
            assert torch.equal(v, outs[1]["metrics"][k]), (family, epoch, k)


# ----------------------------------------------------------------- config
def test_config_checks_match_jax():
    """JAX ``tests/test_device_cache.py::test_steps_per_execution_validation``
    and the pipeline depth's check, on both configs."""
    for cls in (BaseTrainerConfig, JTrainerConfig):
        with pytest.raises(AttributeError, match="steps_per_execution"):
            cls(steps_per_execution=0)
        with pytest.raises(AttributeError, match="cache_on_device"):
            cls(steps_per_execution=4)
        with pytest.raises(AttributeError, match="pipeline_depth"):
            cls(pipeline_depth=0)
        cfg = cls(steps_per_execution=4, cache_on_device=True)
        assert (cfg.steps_per_execution, cfg.pipeline_epochs, cfg.pipeline_depth) == (4, True, 8)
