"""The port's checkpoints, resume, ``keep_best_on_train`` and sanity check
against the JAX trainer's, on the CPU at a small size: MVTCAE on the MLP
nets (3 modalities, latent 8, hidden 16), 20 train rows in batches of 8
(the last one padded), a 12-row eval set; and TELBO through the
``MultistageTrainer`` for its boundary checkpoint.

Weights cross with ``params_from_jax``; the port's noise is the JAX
trainer's (``fold_in(key(seed), step)`` a train step, ``key(seed + 1000 +
epoch)`` an eval step), fed through ``draw_noise``; a resumed JAX trainer
restarts its step at ``trained_epochs x steps an epoch``, and so does the
port's feed. Compared: the epoch curves (1e-4 relative: float32 drift over
a dozen Adam steps of two implementations, as in the other trainer
tests), the checkpoint epochs and ``info_checkpoint.json``, the kept and
live weights (``torch_parity.assert_same_moves``). The port's own resume,
on its own generator, is held to its uninterrupted run exactly. With
``checkpoint_backend="orbax"`` both packages write the train state sharded
(``train_state/``; the port's own torch files and index) and resume from
it; the port's saves run in the background with ``async_checkpointing``.
"""

import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers import MultistageTrainer as JMultistageTrainer
from multivae_tpu.trainers import MultistageTrainerConfig as JMultistageTrainerConfig
from multivae_tpu.trainers.base.optim import make_scheduler as make_jax_scheduler
from multivae_tpu_torch.data import MultimodalBaseDataset
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import (
    BaseTrainer,
    BaseTrainerConfig,
    MultistageTrainer,
    MultistageTrainerConfig,
)
from multivae_tpu_torch.trainers.base import checkpoint as sharded
from multivae_tpu_torch.trainers.base.optim import _SCHEDULERS
from test_torch_telbo import _arrays as telbo_arrays
from test_torch_telbo import _models as telbo_models
from test_torch_telbo import _stage_noise as telbo_noise
from torch_parity import Recorder, assert_same_moves, feed_trainer_noise, normal, port_model, state_of

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED, LR = 8, 16, 8, 11, 1e-3
STEPS = 3   # 20 rows in batches of 8
CURVE_RTOL = 1e-4
CHECKPOINT_FILES = {"environment.json", "generator.pt", "info_checkpoint.json",
                    "live_params.pt", "model.pt", "model_config.json", "optimizer.pt",
                    "training_config.json"}
JAX_NAMES = {"live_params.pt": "live_params.msgpack", "model.pt": "model.msgpack",
             "optimizer.pt": "optimizer.msgpack"}
# "orbax": the live weights, the optimizer's and the generator's states in
# the sharded train state instead
SHARDED_FILES = CHECKPOINT_FILES - {"generator.pt", "live_params.pt", "optimizer.pt"} | {
    "train_state"}


def _models():
    kw = dict(n_modalities=3, latent_dim=LATENT, input_dims=DIMS,
              uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
              decoder_dist_params={"m2": {"scale": 0.75}}, alpha=0.3, beta=2.5)
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    jmodel = JMVTCAE(JMVTCAEConfig(**kw),
                     encoders={m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                     decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                     seed=0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    tmodel = MVTCAE(MVTCAEConfig(**kw),
                    encoders={m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                    decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                    device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _arrays(seed, n):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


DATA, EVAL = _arrays(4, 20), _arrays(5, 12)


def _keyed_noise(key):
    return lambda shape, generator=None: normal(key, shape)


def _common(**extra):
    kw = dict(num_epochs=4, learning_rate=LR, per_device_train_batch_size=B,
              per_device_eval_batch_size=B, seed=SEED, optimizer_cls="Adam",
              steps_saving=2)
    kw.update(extra)
    return kw


def _port_trainer(tmodel, out, checkpoint=None, **extra):
    return BaseTrainer(tmodel, MultimodalBaseDataset(DATA), MultimodalBaseDataset(EVAL),
                       checkpoint=checkpoint, device="cpu",
                       training_config=BaseTrainerConfig(output_dir=str(out),
                                                         **_common(**extra)))


def _jax_run(jmodel, out, checkpoint=None, **extra):
    rec = Recorder()
    trainer = JTrainer(jmodel, JDataset(DATA), JDataset(EVAL), callbacks=[rec],
                       checkpoint=checkpoint,
                       training_config=JTrainerConfig(output_dir=str(out), n_devices=1,
                                                      **_common(**extra)))
    trainer.train()
    return trainer, rec.logs


def _curve(logs, key="train_epoch_loss"):
    return [h[key] for h in logs]


def _fed_runs(tmp, tmodel, full_epochs=4, **extra):
    """The port fed the JAX draws, ``full_epochs`` epochs with a checkpoint
    every 2, and resumed from its ``checkpoint_epoch_2`` to epoch 4."""
    full = _port_trainer(tmodel, tmp / "torch", num_epochs=full_epochs, **extra)
    feed_trainer_noise(full, tmodel, _keyed_noise, SEED)
    full.train()
    resumed_model = _models()[1]
    resumed = _port_trainer(resumed_model, tmp / "torch_resumed", **extra,
                            checkpoint=os.path.join(full.training_dir, "checkpoint_epoch_2"))
    steps = feed_trainer_noise(resumed, resumed_model, _keyed_noise, SEED,
                               first_step=2 * STEPS)
    resumed.train()
    assert next(steps) == 4 * STEPS
    return full, resumed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer and the port, 4 epochs with a checkpoint every 2, each
    then resumed from its own ``checkpoint_epoch_2``; and both again with
    ``checkpoint_backend="orbax"``, where the first run stops at the
    checkpoint the resume needs (the JAX trainers' compiles and orbax saves
    are most of the file's time)."""
    tmp = tmp_path_factory.mktemp("checkpoint")
    out = {}
    for backend, epochs in (("msgpack", 4), ("orbax", 2)):
        jmodel, tmodel = _models()
        out["start"] = {k: v.clone() for k, v in tmodel.state_dict().items()}
        jfull, jlogs = _jax_run(jmodel, tmp / backend / "jax", checkpoint_backend=backend,
                                num_epochs=epochs)
        jresumed, jresumed_logs = _jax_run(
            _models()[0], tmp / backend / "jax_resumed", checkpoint_backend=backend,
            checkpoint=os.path.join(jfull.training_dir, "checkpoint_epoch_2"))
        full, resumed = _fed_runs(tmp / backend, tmodel, full_epochs=epochs,
                                  checkpoint_backend=backend)
        out[backend] = dict(jfull=jfull, jlogs=jlogs, jresumed=jresumed,
                            jresumed_logs=jresumed_logs, full=full, resumed=resumed)
    return {"start": out["start"], **out["msgpack"], "orbax": out["orbax"]}


def _info(trainer, epoch):
    with open(os.path.join(trainer.training_dir, f"checkpoint_epoch_{epoch}",
                           "info_checkpoint.json")) as f:
        return json.load(f)


def test_checkpointed_curve_and_info_match_jax(runs):
    full, jfull = runs["full"], runs["jfull"]
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        np.testing.assert_allclose(_curve(full.history, key), _curve(runs["jlogs"], key),
                                   rtol=CURVE_RTOL, err_msg=key)

    def checkpoints(trainer):
        return sorted(d for d in os.listdir(trainer.training_dir)
                      if d.startswith("checkpoint_epoch_"))

    assert checkpoints(full) == checkpoints(jfull) == ["checkpoint_epoch_2",
                                                       "checkpoint_epoch_4"]
    for epoch in (2, 4):
        ours, ref = _info(full, epoch), _info(jfull, epoch)
        assert set(ours) == set(ref) == {"training_dir", "trained_epochs",
                                         "best_train_loss", "best_eval_loss"}
        assert ours["trained_epochs"] == ref["trained_epochs"] == epoch
        assert ours["training_dir"] == full.training_dir
        # no keep_best_on_train: the train loss is never tracked
        assert ours["best_train_loss"] == ref["best_train_loss"] == float("inf")
        np.testing.assert_allclose(ours["best_eval_loss"], ref["best_eval_loss"],
                                   rtol=CURVE_RTOL)
        files = set(os.listdir(os.path.join(full.training_dir, f"checkpoint_epoch_{epoch}")))
        assert files == CHECKPOINT_FILES | {"encoders.pkl", "decoders.pkl"}
        # the JAX layout, with torch files for its msgpack ones, and the
        # generator's state where the JAX trainer re-derives its keys
        jfiles = set(os.listdir(os.path.join(jfull.training_dir, f"checkpoint_epoch_{epoch}")))
        assert {JAX_NAMES.get(f, f) for f in files - {"generator.pt"}} == jfiles


def _assert_same_resume(one, start):
    resumed, jresumed = one["resumed"], one["jresumed"]
    assert resumed.trained_epochs == jresumed.trained_epochs == 2
    assert len(resumed.history) == len(one["jresumed_logs"]) == 2
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        np.testing.assert_allclose(_curve(resumed.history, key),
                                   _curve(one["jresumed_logs"], key),
                                   rtol=CURVE_RTOL, err_msg=key)
    assert_same_moves(resumed.model.state_dict(), state_of(jresumed.state.params), start, LR)
    assert_same_moves(resumed._best_state, state_of(jresumed.best_params), start, LR)


def test_resume_matches_the_jax_resume(runs):
    """Epochs 3-4 from ``checkpoint_epoch_2`` in both packages: the same
    curve, and the same kept and live weights at the end."""
    _assert_same_resume(runs, runs["start"])


def test_sharded_resume_matches_the_jax_orbax_resume(runs):
    """``checkpoint_backend="orbax"`` in both packages: each resumes epochs
    3-4 from its own sharded train state (the live weights and the
    optimizer's state; the port's also holds the generator's), with the
    same curve and kept and live weights; both checkpoints hold the same
    files but for the weights' format, and no whole optimizer or live
    weights file."""
    one = runs["orbax"]
    _assert_same_resume(one, runs["start"])
    for trainer, names in ((one["full"], SHARDED_FILES),
                           (one["jfull"], {JAX_NAMES.get(f, f) for f in SHARDED_FILES})):
        files = set(os.listdir(os.path.join(trainer.training_dir, "checkpoint_epoch_2")))
        assert files - {"encoders.pkl", "decoders.pkl"} == names


def test_resumed_run_repeats_the_uninterrupted_one(tmp_path):
    """On its own generator (no JAX draws): the port resumed from
    ``checkpoint_epoch_2`` gives the uninterrupted run's epochs 3-4 and
    weights exactly, because the checkpoint carries the live weights, the
    optimizer's state and the generator's."""
    full = _port_trainer(_models()[1], tmp_path / "full")
    full.train()
    resumed = _port_trainer(_models()[1], tmp_path / "resumed",
                            checkpoint=os.path.join(full.training_dir, "checkpoint_epoch_2"))
    resumed.train()
    assert resumed.history == full.history[2:]
    for name, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], v), name
    for name, v in full._best_state.items():
        assert torch.equal(resumed._best_state[name], v), name
    # without the generator's state the resumed run draws other noise
    bare = tmp_path / "bare"
    os.makedirs(bare)
    source = os.path.join(full.training_dir, "checkpoint_epoch_2")
    for f in os.listdir(source):
        if f != "generator.pt":
            with open(os.path.join(source, f), "rb") as src, open(bare / f, "wb") as dst:
                dst.write(src.read())
    other = _port_trainer(_models()[1], tmp_path / "other", checkpoint=str(bare))
    other.train()
    assert other.history[0]["train_epoch_loss"] != full.history[2]["train_epoch_loss"]


def _assert_same_run(ours, ref):
    assert ours.history == ref.history[-len(ours.history):]
    for name, v in ref.model.state_dict().items():
        assert torch.equal(ours.model.state_dict()[name], v), name
    for name, v in ref._best_state.items():
        assert torch.equal(ours._best_state[name], v), name


@pytest.mark.parametrize("async_checkpointing", [True, False])
def test_sharded_resume_repeats_the_uninterrupted_run(tmp_path, async_checkpointing):
    """``checkpoint_backend="orbax"`` with a checkpoint every epoch (JAX
    ``test_orbax_async_checkpointing_durable_and_correct``): when ``train()``
    returns every epoch's ``train_state/`` is committed, with no temporary
    folder left, and holds this process's pieces (one rank: the whole
    leaves), the index and the common state. An asynchronous save returns
    before its files are written, a blocking one once it is committed.
    Resumed from ``checkpoint_epoch_2``, on its own generator, the port
    repeats epochs 3-4 and the weights, kept and live, bit for bit."""
    extra = dict(checkpoint_backend="orbax", async_checkpointing=async_checkpointing,
                 steps_saving=1)
    writers = {t for t in threading.enumerate() if t.name.startswith("checkpoint-writer")}
    full = _port_trainer(_models()[1], tmp_path / "full", **extra)
    full.train()
    for epoch in range(1, 5):
        path = os.path.join(full.training_dir, f"checkpoint_epoch_{epoch}")
        assert set(os.listdir(path)) - {"encoders.pkl", "decoders.pkl"} == SHARDED_FILES
        assert sorted(os.listdir(os.path.join(path, "train_state"))) == [
            "common.pt", "index.json", "rank_0.pt"]
    assert set(full.checkpoint_times) == {"blocked_s", "copy_s", "written_s", "commit_s",
                                          "bytes"}
    # train() stopped its writer thread
    assert {t for t in threading.enumerate()
            if t.name.startswith("checkpoint-writer")} <= writers
    resumed = _port_trainer(_models()[1], tmp_path / "resumed", **extra,
                            checkpoint=os.path.join(full.training_dir, "checkpoint_epoch_2"))
    resumed.train()
    _assert_same_run(resumed, full)

    # a save whose writer is held: async, it returns with nothing committed
    release, plain = threading.Event(), sharded._write

    def held(folder, files):
        assert release.wait(30)
        return plain(folder, files)

    sharded._write = held
    try:
        if async_checkpointing:
            full.save_checkpoint(str(tmp_path / "held"), epoch=5)
            assert not os.path.exists(tmp_path / "held" / "checkpoint_epoch_5" / "train_state")
            release.set()
            full.wait_for_checkpoint()
        else:
            release.set()
            full.save_checkpoint(str(tmp_path / "held"), epoch=5)
    finally:
        sharded._write = plain
    assert os.path.isdir(tmp_path / "held" / "checkpoint_epoch_5" / "train_state")
    assert not os.path.exists(tmp_path / "held" / "checkpoint_epoch_5" / "train_state.tmp")


def test_keep_best_chunked_run_resumes_from_a_sharded_checkpoint(tmp_path):
    """Keep-best on the train loss, at a rate (0.3) where the loss is not
    monotonic, with chunks of ``steps_per_execution`` 2 on the device cache
    (JAX ``test_fused_epoch_blocks_keep_best_checkpoint_resume[orbax-1]``):
    resumed from a sharded checkpoint, the kept and the final weights are
    the uninterrupted run's, bit for bit."""
    extra = dict(checkpoint_backend="orbax", num_epochs=5, keep_best_on_train=True,
                 learning_rate=0.3, cache_on_device=True, steps_per_execution=2)
    full = _port_trainer(_models()[1], tmp_path / "full", **extra)
    full.train()
    losses = _curve(full.history)
    # the precondition: the kept weights are not the final ones
    assert int(np.argmin(losses)) != len(losses) - 1, losses
    resumed = _port_trainer(_models()[1], tmp_path / "resumed", **extra,
                            checkpoint=os.path.join(full.training_dir, "checkpoint_epoch_2"))
    resumed.train()
    assert resumed.best_train_loss == full.best_train_loss
    _assert_same_run(resumed, full)


def test_a_broken_sharded_checkpoint_raises(tmp_path, monkeypatch):
    """No fall-back to the whole files: a train state without a rank's file,
    or never committed, raises naming it; a writer's error raises at the
    next wait, here the end of ``train()``."""
    full = _port_trainer(_models()[1], tmp_path / "full", checkpoint_backend="orbax",
                         num_epochs=2)
    full.train()
    source = os.path.join(full.training_dir, "checkpoint_epoch_2")
    missing, uncommitted = tmp_path / "missing", tmp_path / "uncommitted"
    shutil.copytree(source, missing)
    os.remove(missing / "train_state" / "rank_0.pt")
    with pytest.raises(FileNotFoundError, match="rank_0.pt"):
        _port_trainer(_models()[1], tmp_path / "a", checkpoint=str(missing))
    shutil.copytree(source, uncommitted)
    os.rename(uncommitted / "train_state", uncommitted / "train_state.tmp")
    with pytest.raises(RuntimeError, match="not committed"):
        _port_trainer(_models()[1], tmp_path / "b", checkpoint=str(uncommitted))

    def broken(folder, files):
        raise OSError("disk full")

    monkeypatch.setattr(sharded, "_write", broken)
    trainer = _port_trainer(_models()[1], tmp_path / "c", checkpoint_backend="orbax",
                            num_epochs=2)
    with pytest.raises(RuntimeError, match="checkpoint writer of rank 0 failed") as err:
        trainer.train()
    assert "disk full" in str(err.value)
    assert not os.path.exists(os.path.join(trainer.training_dir, "checkpoint_epoch_2",
                                           "train_state"))


SCHEDULER_PARAMS = {
    "StepLR": {"step_size": 1, "gamma": 0.5},
    "MultiStepLR": {"milestones": [2, 4], "gamma": 0.5},
    "ExponentialLR": {"gamma": 0.5},
    "LinearLR": {"start_factor": 0.25, "total_iters": 3},
    "ConstantLR": {"factor": 0.5, "total_iters": 3},
    "PolynomialLR": {"total_iters": 3, "power": 2.0},
    "CosineAnnealingLR": {"T_max": 3},
    "CosineAnnealingWarmRestarts": {"T_0": 3},
    "ReduceLROnPlateau": {"mode": "max", "patience": 0, "factor": 0.5},
}


def _record_rates(trainer):
    """The rate in force after each epoch's scheduler step."""
    rates = []
    finalize = trainer._finalize_epoch

    def finalize_and_record(*args):
        finalize(*args)
        rates.append(trainer.optimizer.param_groups[0]["lr"])

    trainer._finalize_epoch = finalize_and_record
    return rates


@pytest.mark.parametrize("scheduler", sorted(SCHEDULER_PARAMS))
def test_scheduler_state_is_carried_across_the_resume(tmp_path, scheduler):
    """Every scheduler the trainer takes, resumed from
    ``checkpoint_epoch_2``: the rate of epochs 3-4 is the uninterrupted
    run's, epoch by epoch, and so are the losses and the scheduler's state.
    StepLR halves the rate every epoch; ReduceLROnPlateau (mode max,
    patience 0) cuts it at every epoch that does not raise the eval loss,
    which needs its ``best`` and bad-epoch count; MultiStepLR (milestones
    [2, 4]) must decay again at epoch 4 after the resume, and its rates are
    the JAX trainer's schedule."""
    assert set(SCHEDULER_PARAMS) == set(_SCHEDULERS)
    extra = dict(scheduler_cls=scheduler, scheduler_params=SCHEDULER_PARAMS[scheduler])
    full = _port_trainer(_models()[1], tmp_path / "full", **extra)
    full_rates = _record_rates(full)
    full.train()
    resumed = _port_trainer(_models()[1], tmp_path / "resumed", **extra,
                            checkpoint=os.path.join(full.training_dir, "checkpoint_epoch_2"))
    # the resumed trainer starts from the rate of the checkpoint's epoch
    assert resumed.optimizer.param_groups[0]["lr"] == full_rates[1]
    if scheduler in ("StepLR", "ReduceLROnPlateau"):
        # both cut the rate at epoch 2
        assert full_rates[1] == LR / (4 if scheduler == "StepLR" else 2)
    resumed_rates = _record_rates(resumed)
    resumed.train()
    assert resumed_rates == full_rates[2:]
    assert resumed.history == full.history[2:]
    assert resumed.optimizer.param_groups[0]["lr"] == full.optimizer.param_groups[0]["lr"]
    assert resumed.scheduler.state_dict() == full.scheduler.state_dict()
    if scheduler == "MultiStepLR":
        jax_schedule = make_jax_scheduler(scheduler, LR, SCHEDULER_PARAMS[scheduler])
        expected = [jax_schedule.lr_at(epoch) for epoch in range(1, 5)]
        np.testing.assert_allclose(full_rates, expected, rtol=1e-12)
        assert full_rates[3] == full_rates[1] / 2


def test_keep_best_on_train_matches_jax(tmp_path):
    """``keep_best_on_train``: the weights of the best train loss, against
    the JAX trainer's ``best_params``, over 5 epochs at a rate (0.1) where
    the last epoch is worse on train than the fourth, and the eval loss is
    best at epoch 2: the kept weights are epoch 4's, where the eval loss
    would have kept epoch 2's."""
    jmodel, tmodel = _models()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    extra = dict(num_epochs=5, steps_saving=None, keep_best_on_train=True,
                 learning_rate=0.1)
    jtrainer, jlogs = _jax_run(jmodel, tmp_path / "jax", **extra)
    trainer = _port_trainer(tmodel, tmp_path / "torch", **extra)
    feed_trainer_noise(trainer, tmodel, _keyed_noise, SEED)
    states = []
    finalize = trainer._finalize_epoch

    def finalize_and_record(*args):
        finalize(*args)
        states.append({k: v.clone() for k, v in tmodel.state_dict().items()})

    trainer._finalize_epoch = finalize_and_record
    trainer.train()
    losses = _curve(trainer.history)
    np.testing.assert_allclose(losses, _curve(jlogs), rtol=CURVE_RTOL)
    best = int(np.argmin(losses))
    evals = _curve(trainer.history, "eval_epoch_loss")
    # the precondition: neither the last epoch nor the best eval epoch
    assert best == 3 and int(np.argmin(evals)) == 1, (losses, evals)
    assert trainer.best_train_loss == losses[best]
    np.testing.assert_allclose(trainer.best_train_loss, jtrainer.best_train_loss,
                               rtol=CURVE_RTOL)
    assert trainer.best_eval_loss == jtrainer.best_eval_loss == float("inf")
    for name, v in states[best].items():
        assert torch.equal(trainer._best_state[name], v), name
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 0.1)


def test_sanity_check_refuses_bad_data_like_jax(tmp_path):
    """Data of the wrong width: both trainers raise ValueError at
    construction, with the same message."""
    bad = dict(DATA, m0=np.ones((20, 7), np.float32))
    jmodel, tmodel = _models()
    with pytest.raises(ValueError) as jerr:
        JTrainer(jmodel, JDataset(bad), training_config=JTrainerConfig(
            output_dir=str(tmp_path / "jax"), n_devices=1))
    with pytest.raises(ValueError) as err:
        BaseTrainer(tmodel, MultimodalBaseDataset(bad), device="cpu",
                    training_config=BaseTrainerConfig(output_dir=str(tmp_path / "torch")))
    head = "Error when calling forward on a batch of the training dataset."
    assert str(err.value).startswith(head) and str(jerr.value).startswith(head)


def test_sanity_check_leaves_the_training_generator(tmp_path):
    """The sanity check's forward draws from a generator of its own: the
    training generator is where a fresh one seeded with the config's seed
    is, so the first step's noise does not move."""
    trainer = _port_trainer(_models()[1], tmp_path)
    fresh = torch.Generator().manual_seed(SEED)
    assert torch.equal(trainer.generator.get_state(), fresh.get_state())


def test_telbo_boundary_checkpoint_and_resume_match_jax(tmp_path):
    """TELBO, warm-up 2, 3 epochs, SGD (where the two packages agree through
    stage 2, ROADMAP Queue C): both ``MultistageTrainer``s save
    ``checkpoint_epoch_1`` before the optimizer reset at epoch 2; resumed
    from it, each resets again and runs epochs 2-3 as its uninterrupted run
    did."""
    data, eval_data = telbo_arrays(seed=5, n=20), telbo_arrays(seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=LR, per_device_train_batch_size=B,
                  per_device_eval_batch_size=B, seed=SEED, optimizer_cls="SGD")
    runs = {}
    for name in ("full", "resumed"):
        jmodel, tmodel = telbo_models()
        checkpoint = (None if name == "full" else
                      os.path.join(runs["full"][0].training_dir, "checkpoint_epoch_1"))
        rec = Recorder()
        jtrainer = JMultistageTrainer(
            jmodel, JDataset(data), JDataset(eval_data), callbacks=[rec],
            checkpoint=checkpoint, training_config=JMultistageTrainerConfig(
                output_dir=str(tmp_path / f"jax_{name}"), n_devices=1, **common))
        jtrainer.train()
        tcheckpoint = (None if name == "full" else
                       os.path.join(runs["full"][2].training_dir, "checkpoint_epoch_1"))
        trainer = MultistageTrainer(
            tmodel, MultimodalBaseDataset(data), MultimodalBaseDataset(eval_data),
            checkpoint=tcheckpoint, device="cpu", training_config=MultistageTrainerConfig(
                output_dir=str(tmp_path / f"torch_{name}"), **common))
        first = 0 if name == "full" else STEPS
        steps = feed_trainer_noise(trainer, tmodel, telbo_noise(tmodel), SEED, first_step=first)
        first_optimizer = trainer.optimizer
        trainer.train()
        assert next(steps) == 3 * STEPS
        # the resumed run resets again at epoch 2, as the uninterrupted one did
        assert trainer.optimizer is not first_optimizer and tmodel.current_stage == 2
        runs[name] = (jtrainer, rec.logs, trainer)
    jfull, jlogs, full = runs["full"]
    jresumed, jresumed_logs, resumed = runs["resumed"]
    for trainer in (jfull, full):
        path = os.path.join(trainer.training_dir, "checkpoint_epoch_1")
        with open(os.path.join(path, "info_checkpoint.json")) as f:
            assert json.load(f)["trained_epochs"] == 1
    assert CHECKPOINT_FILES <= set(os.listdir(os.path.join(full.training_dir,
                                                           "checkpoint_epoch_1")))
    assert len(resumed.history) == len(jresumed_logs) == 2
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        np.testing.assert_allclose(_curve(full.history, key), _curve(jlogs, key),
                                   rtol=CURVE_RTOL, err_msg=key)
        np.testing.assert_allclose(_curve(resumed.history, key),
                                   _curve(jresumed_logs, key), rtol=CURVE_RTOL, err_msg=key)
        # the same JAX draws on both port runs: the resume is exact
        assert _curve(resumed.history, key) == _curve(full.history, key)[1:]
    for name, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], v), name
