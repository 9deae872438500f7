"""The port's TELBO and MultistageTrainer against the JAX package's, on the
CPU at a small size: 3 modalities on the MLP nets (hidden 16), latent 8,
batch 8, the default joint encoder.

Weights cross with ``params_from_jax``; noise is the JAX package's
``jax.random.normal`` of each call's key (stage 2: one key per modality,
``split(key, M)``), handed to the port through ``draw_noise``. Compared:
both stages' loss, outputs, metrics and gradients, the frozen groups'
gradients None in the port and zero in JAX; the stages and the refused
subsets; the port's BaseTrainer refusing TELBO; and 3 epochs of
``MultistageTrainer`` with warm-up 2 and an eval set, against the JAX
``MultistageTrainer``: the optimizer reset at the start of epoch 2, the
stage flip at epoch 3, the epoch losses, the learning rate after the reset
and the kept weights.

Frozen weights: the port freezes the joint encoder and the decoders with
``requires_grad_(False)``: their gradients stay None and the optimizer
leaves them alone, as torch's does in the reference. The JAX package stops
their gradients, which optax sees as zeros, and optax steps every
parameter at each step: its Adam goes on moving the frozen weights with the
momentum of epoch 2, and its bias correction treats the unimodal encoders,
idle in stage 1, as if they had taken every step. Under plain SGD, where a
zero gradient is no update, the two agree through stage 2; under Adam they
agree up to the flip, and the port's frozen weights stay put after it.
"""

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import TELBO as JTELBO
from multivae_tpu.models import TELBOConfig as JTELBOConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.trainers import MultistageTrainer as JMultistageTrainer
from multivae_tpu.trainers import MultistageTrainerConfig as JMultistageTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import TELBO, TELBOConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import (
    BaseTrainer,
    BaseTrainerConfig,
    MultistageTrainer,
    MultistageTrainerConfig,
)
from torch_parity import assert_same_moves, feed_trainer_noise, normal, port_model, state_of

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED = 8, 16, 8, 11
M = len(DIMS)
# As in test_torch_jmvae.py: sums of 10^2-10^3 float32 terms in another
# order, and gradients of such sums through 4 to 6 layers.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
FROZEN = ("joint_encoder.", "decoders.")


def _config_kwargs(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
              uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
              decoder_dist_params={"m2": {"scale": 0.75}}, warmup=2,
              gamma_factors={"m0": 2.0, "m1": 0.5, "m2": 1.0})
    kw.update(extra)
    return kw


def _models(**extra):
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    jmodel = JTELBO(JTELBOConfig(**_config_kwargs(**extra)),
                    encoders={m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                    decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                    seed=0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    tmodel = TELBO(TELBOConfig(**_config_kwargs(**extra)),
                   encoders={m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                   decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                   device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


def _stage_noise(model):
    """The JAX draws of one loss call by key, for the model's stage."""
    def of_key(key):
        def noise(shape, generator=None):
            if model.current_stage == 1:
                return normal(key, shape)
            return torch.stack([normal(k, shape[1:]) for k in jax.random.split(key, M)])
        return noise
    return of_key


@pytest.mark.parametrize("stage", [1, 2])
def test_loss_metrics_and_every_gradient_match_jax(stage):
    jmodel, tmodel = _models()
    assert tmodel.lambda_factors == jmodel.lambda_factors
    assert tmodel.gamma_factors == jmodel.gamma_factors
    jmodel.set_stage(stage)
    assert tmodel.set_stage(stage) == (stage == 2)
    data = _arrays()
    weights = np.ones(B, np.float32)
    weights[-1] = 0.0            # a loader padding row
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, weights=weights)
    step = JStepInfo.create(epoch=stage + 1, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    shapes = []
    draw = _stage_noise(tmodel)(key)

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return draw(shape)

    tmodel.draw_noise = noise
    out = tmodel.loss_function(batch_from_arrays(data=data, weights=weights),
                               StepInfo(epoch=stage + 1, dataset_size=B))
    out.loss.backward()
    assert shapes == [(B, LATENT) if stage == 1 else (M, B, LATENT)]
    assert set(out) == set(ref)
    for name in ("loss", "loss_sum", "recon_loss", "KLD"):
        if name in ref:
            np.testing.assert_allclose(out[name].item(), float(ref[name]), err_msg=name,
                                       **LOSS_TOL)
    expected = {"kld_joint", "recon_joint"} if stage == 1 else set(DIMS)
    assert set(out.metrics) == set(ref.metrics) == expected
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    # stage 1 trains the joint encoder and the decoders, and the joint encoder
    # reads its copies' embeddings only (their log-variance heads get no
    # gradient); stage 2 freezes the joint encoder and the decoders
    for name, g in grads.items():
        unused = (name.startswith(FROZEN) if stage == 2 else
                  name.startswith("encoders.")
                  or name.startswith("joint_encoder.dict_encoders.") and ".dense.3." in name)
        if unused:
            assert g is None, name
            assert not ref_grads[name].any(), name
            continue
        assert g is not None and np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    assert tmodel.set_stage(1) == (stage == 2)
    assert all(p.requires_grad for p in tmodel.parameters())


def test_stages_and_subsets_like_jax():
    jmodel, tmodel = _models(warmup=3)
    for model in (jmodel, tmodel):
        assert [model.stage_for_epoch(e) for e in (1, 3, 4, 9)] == [1, 1, 2, 2]
        assert model.reset_optimizer_epochs == [3]
        data = _arrays(seed=2)
        with pytest.raises(ValueError, match="not handled"):
            model.encode(data, ["m0", "m1"])
    key = jax.random.key(3)
    for cond in ("m1", "all"):
        ref = jmodel.encode(_arrays(seed=2), cond, N=2, rng=key)
        tmodel.draw_noise = lambda shape, generator=None: normal(key, shape)
        with torch.no_grad():
            out = tmodel.encode(_arrays(seed=2), cond, N=2)
        assert out.z.shape == (2, B, LATENT)
        np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), rtol=1e-5, atol=1e-5)


def test_base_trainer_refuses_telbo(tmp_path):
    _, tmodel = _models()
    with pytest.raises(AttributeError, match="MultistageTrainer"):
        BaseTrainer(tmodel, MultimodalBaseDataset(_arrays()), device="cpu",
                    training_config=BaseTrainerConfig(output_dir=str(tmp_path)))


class _ParamsAtLog(TrainingCallback):
    """The JAX trainer's live parameters at each epoch's log."""

    def __init__(self):
        self.trainer, self.logs, self.params = None, [], []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))
        self.params.append(state_of(self.trainer.state.params))


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_multistage_curve_matches_jax_across_the_boundary(tmp_path, optimizer):
    """Warm-up 2 over 3 epochs (lr 1e-3, StepLR halving the rate each epoch)
    on 20 rows in batches of 8 with a 16-row eval set: epoch 2 starts with
    the optimizer, the scheduler and the best losses reset, from the weights
    kept at epoch 1; epoch 3 is stage 2."""
    data, eval_data = _arrays(seed=5, n=20), _arrays(seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls=optimizer,
                  scheduler_cls="StepLR",
                  scheduler_params={"step_size": 1, "gamma": 0.5})
    jmodel, tmodel = _models()
    rec = _ParamsAtLog()
    jtrainer = JMultistageTrainer(
        jmodel, JDataset(data), JDataset(eval_data), callbacks=[rec],
        training_config=JMultistageTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                 n_devices=1, **common))
    rec.trainer = jtrainer
    jtrainer.train()

    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = MultistageTrainer(tmodel, MultimodalBaseDataset(data),
                                MultimodalBaseDataset(eval_data), device="cpu",
                                training_config=MultistageTrainerConfig(
                                    output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, _stage_noise(tmodel), SEED)
    first_optimizer, lrs, states = trainer.optimizer, [], []
    train_step, finalize = trainer.train_step, trainer._finalize_epoch

    def train_step_logged(epoch):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        return train_step(epoch)

    def finalize_logged(*args):
        finalize(*args)
        states.append({k: v.clone() for k, v in tmodel.state_dict().items()})

    trainer.train_step, trainer._finalize_epoch = train_step_logged, finalize_logged
    trainer.train()
    assert next(steps) == 3 * 3
    assert trainer.optimizer is not first_optimizer and tmodel.current_stage == 2
    # the fresh scheduler restarts at the base rate at the start of epoch 2
    assert lrs == [1e-3, 1e-3, 5e-4]
    jlr = float(jtrainer.state.opt_state.hyperparams["learning_rate"])
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(jlr) == 2.5e-4
    assert set(trainer.history[2]) >= {"train_m0", "eval_m2"}
    n_exact = 3 if optimizer == "SGD" else 2
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        np.testing.assert_allclose(ours[:n_exact], ref[:n_exact], rtol=1e-4, err_msg=key)
    for epoch in range(n_exact):
        assert_same_moves(states[epoch], rec.params[epoch], start, 1e-3)
    # stage 2 leaves the joint encoder and the decoders where epoch 2 left them
    frozen = [k for k in start if k.startswith(FROZEN)]
    assert frozen and all(torch.equal(states[2][k], states[1][k]) for k in frozen)
    assert any(not torch.equal(states[2][k], states[1][k]) for k in start
               if k.startswith("encoders."))
    if n_exact == 3:
        assert trainer.best_eval_loss == pytest.approx(jtrainer.best_eval_loss, rel=1e-4)
        assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)

