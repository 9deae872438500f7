"""The port's JNF against the JAX package's, on the CPU at a small size: 3
modalities on the MLP nets (hidden 16), latent 4, batch 8, the default
joint encoder. The loss and its gradients run with the default MAF flows
(2 blocks of 3 hidden layers of 128); encode, the NLL and the trainer with
a MAF per modality of 2 blocks of one hidden layer of 16, since the JAX
package traces and compiles every layer of every flow pass (the default
MAF's layers are held to Flax in ``test_torch_flows.py``).

Weights cross with ``params_from_jax``; noise is the JAX package's
``jax.random.normal`` of each call's key, handed to the port through
``draw_noise`` (stage 2 draws the joint sample once; the JAX package draws
it twice from the same key, the same numbers). Compared: both stages' loss,
metrics and gradients (the frozen groups' None in the port, zero in JAX);
encode from all modalities, from one (through ``MAF.inverse``) and from a
subset by HMC with the JAX draws fed in key-split order; the joint NLL;
save and reload with default and custom flows; the port's BaseTrainer
refusing JNF; and 3 epochs of ``MultistageTrainer`` with warm-up 1 under
Adam against the JAX ``MultistageTrainer``; and, pinned as a limit, the
idle weights under weight decay.

Frozen weights: as for TELBO, the port freezes the joint encoder and the
decoders with ``requires_grad_(False)``, the JAX package stops their
gradients and optax steps them with zeros. JNF resets the optimizer in the
epoch where the stage flips, so the fresh Adam has no momentum for the
frozen weights and no idle steps for the unimodal encoders and flows: its
zero-gradient updates are exactly zero, and the two trainers agree through
stage 2 (pinned below).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import JNF as JJNF
from multivae_tpu.models import JNFConfig as JJNFConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.ops.flows import MAF as JMAF
from multivae_tpu.trainers import MultistageTrainer as JMultistageTrainer
from multivae_tpu.trainers import MultistageTrainerConfig as JMultistageTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu.trainers.base.optim import make_optimizer as j_make_optimizer
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import JNF, JNFConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops.flows import IAF, MAF
from multivae_tpu_torch.trainers import (
    BaseTrainer,
    BaseTrainerConfig,
    MultistageTrainer,
    MultistageTrainerConfig,
)
from multivae_tpu_torch.trainers.base.optim import make_optimizer
from torch_parity import assert_same_moves, chain, feed_trainer_noise, normal, state_of, uniform

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED = 4, 16, 8, 11
M = len(DIMS)
# As in test_torch_telbo.py: sums of 10^2-10^3 float32 terms in another
# order, and gradients of such sums through 4 to 8 layers.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# encode: a few matmuls, or LATENT sequential MADE passes per block
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
# HMC: 3 steps of 2 leapfrog steps, each through the flows' gradients
HMC_TOL = dict(rtol=1e-4, atol=1e-5)
FROZEN = ("joint_encoder.", "decoders.")
HMC = dict(mcmc_steps=3, n_lf=2, eps_lf=0.1)
FLOW = dict(n_made_blocks=2, n_hidden_in_made=1, hidden_size=16)
JNF_MODULE = JJNF.__module__


def _config_kwargs(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
              uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
              decoder_dist_params={"m2": {"scale": 0.75}}, warmup=1, beta=0.7)
    kw.update(extra)
    return kw


def _jax_model(flows="small", **extra):
    """The JAX package's JNF with the small flows, or the default ones
    (``flows=None``)."""
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    if flows == "small":
        flows = {m: JMAF(input_dim=LATENT, **FLOW) for m in DIMS}
    return JJNF(JJNFConfig(**_config_kwargs(**extra)),
                encoders={m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                flows=flows, seed=0)


def _port_model(jmodel=None, flows="small", **extra):
    """The port's JNF with the small flows, the default ones (None) or
    ``flows``; with ``jmodel``'s weights if given."""
    if flows == "small":
        flows = {m: MAF(LATENT, **FLOW) for m in DIMS}
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    tmodel = JNF(JNFConfig(**_config_kwargs(**extra)),
                 encoders={m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                 decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                 flows=flows, device="cpu")
    if jmodel is not None:
        tmodel.load_state_dict(state_of(jmodel.params))
    return tmodel


@pytest.fixture(scope="module")
def jmodel():
    return _jax_model()


@pytest.fixture(scope="module")
def jmodel_default_flows():
    return _jax_model(flows=None)


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


def _keyed_noise(key):
    return lambda shape, generator=None: normal(key, shape)


@pytest.mark.parametrize("stage", [1, 2])
def test_loss_metrics_and_every_gradient_match_jax(jmodel_default_flows, stage):
    jmodel = jmodel_default_flows
    tmodel = _port_model(jmodel, flows=None)
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

    try:
        (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    finally:
        jmodel.set_stage(1)
    shapes = []

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return normal(key, shape)

    tmodel.draw_noise = noise
    out = tmodel.loss_function(batch_from_arrays(data=data, weights=weights),
                               StepInfo(epoch=stage + 1, dataset_size=B))
    out.loss.backward()
    assert shapes == [(B, LATENT)]       # one joint draw in either stage
    assert set(out) == set(ref) == {"loss", "loss_sum", "metrics"}
    for name in ("loss", "loss_sum"):
        np.testing.assert_allclose(out[name].item(), float(ref[name]), err_msg=name,
                                   **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"kld_prior", "recon_loss", "ljm"}
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    assert (out.metrics["ljm"].item() == 0.0) == (stage == 1)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    # stage 1 trains the joint encoder (not its copies' log-variance heads)
    # and the decoders; stage 2 the unimodal encoders and the flows
    for name, g in grads.items():
        unused = (name.startswith(FROZEN) if stage == 2 else
                  name.startswith(("encoders.", "flows."))
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


def test_stages_reset_epoch_and_trainer_like_jax(jmodel, tmp_path):
    for model in (jmodel, _port_model()):
        assert [model.stage_for_epoch(e) for e in (1, 2, 9)] == [1, 2, 2]
        assert model.reset_optimizer_epochs == [2]
    tmodel = _port_model(flows=None, warmup=3)
    assert [tmodel.stage_for_epoch(e) for e in (1, 3, 4, 9)] == [1, 1, 2, 2]
    assert tmodel.reset_optimizer_epochs == [4]
    assert isinstance(tmodel.flows["m0"], MAF) and tmodel.flows["m0"].input_dim == LATENT
    assert tmodel.model_config.custom_architectures == ["encoders", "decoders"]
    with pytest.raises(AttributeError, match="keys of provided flows"):
        _port_model(flows={"m0": MAF(LATENT)})
    with pytest.raises(AttributeError, match="input_dim"):
        _port_model(flows={m: MAF(LATENT + 1) for m in DIMS})
    # the port's BaseTrainer refuses JNF, as the JAX one does
    with pytest.raises(AttributeError, match="MultistageTrainer"):
        BaseTrainer(tmodel, MultimodalBaseDataset(_arrays()), device="cpu",
                    training_config=BaseTrainerConfig(output_dir=str(tmp_path)))


@pytest.mark.parametrize("cond, n, flatten", [("all", 1, False), ("m1", 1, False),
                                               ("m1", 2, True)])
def test_encode_all_and_one_modality_match_jax(jmodel, cond, n, flatten):
    """All modalities: the joint encoder; one: the unimodal posterior sample
    through ``MAF.inverse``."""
    tmodel = _port_model(jmodel)
    data = _arrays(seed=2)
    key = jax.random.key(3)
    ref = jmodel.encode(data, cond, N=n, flatten=flatten, rng=key)
    tmodel.draw_noise = _keyed_noise(key)
    out = tmodel.encode(data, cond, N=n, flatten=flatten)
    assert out.z.shape == ((B, LATENT) if n == 1 else (2 * B, LATENT))
    assert not out.z.requires_grad
    assert out.cond_mod == (list(DIMS) if cond == "all" else [cond])
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)


def _hmc_draws(key, n_rows, n_experts, steps):
    """The JAX package's draws of ``_sample_from_poe_subset`` for ``key``, in
    the order the port asks for them: the expert per row and the start's
    noise, then each step's momentum and accept uniforms."""
    rng, init_rng = jax.random.split(key)
    _, c_rng, s_rng = jax.random.split(init_rng, 3)
    expert = torch.tensor(np.asarray(jax.random.randint(c_rng, (n_rows,), 0, n_experts)))
    noise, uniforms = [normal(s_rng, (n_rows, LATENT))], []
    for _ in range(steps):
        rng, g_rng, a_rng = jax.random.split(rng, 3)
        noise.append(normal(g_rng, (n_rows, LATENT)))
        uniforms.append(uniform(a_rng, (n_rows,)))
    return expert, noise, uniforms


class _AcceptTests:
    """Stands in for ``jax.random.uniform`` while the JAX package traces its
    HMC: the uniforms it returns to ``jnf_model`` compare as the package's do
    (``u < alpha``), and each comparison also reports |u - alpha| and the
    decision of the run, from inside the compiled loop."""

    def __init__(self):
        self.margins, self.accepts = [], []
        self._uniform = jax.random.uniform

    def __call__(self, key, shape, *args, **kwargs):
        u = self._uniform(key, shape, *args, **kwargs)
        # the HMC's draws only (Flax's initializers draw uniforms too)
        caller = sys._getframe(1).f_globals["__name__"]
        return _Uniform(self, u) if caller == JNF_MODULE else u

    def record(self, margin, accept):
        self.margins.append(np.asarray(margin))
        self.accepts.append(np.asarray(accept))


class _Uniform:
    def __init__(self, tests, u):
        self.tests, self.u = tests, u

    def __lt__(self, alpha):
        accept = self.u < alpha
        jax.debug.callback(self.tests.record, jnp.abs(self.u - alpha), accept)
        return accept


def test_encode_subset_by_hmc_matches_jax(jmodel):
    """A 2-modality subset, N=2 (the data repeated twice): the port's chain
    with the JAX draws makes the JAX package's accept decisions and ends
    where its chain does."""
    tmodel = _port_model(jmodel)
    data = {m: v[:4] for m, v in _arrays(seed=4).items()}
    subset = ("m0", "m2")
    key = jax.random.key(5)
    tests = _AcceptTests()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax.random, "uniform", tests)
        ref = np.asarray(jmodel.encode(data, list(subset), N=2, rng=key, **HMC).z)
    # the JAX run decides each of its 3 x 8 accept tests by more than 1e-4,
    # and it accepts some proposals and rejects others
    margins, accepts = np.concatenate(tests.margins), np.concatenate(tests.accepts)
    assert margins.shape == (3 * 8,)
    assert margins.min() > 1e-4 and accepts.any() and not accepts.all()

    expert, noise, uniforms = _hmc_draws(key, 8, len(subset), HMC["mcmc_steps"])
    experts, us = [], list(uniforms)

    def draw_experts(n_experts, n_rows, generator=None):
        experts.append((n_experts, n_rows))
        return expert

    tmodel.draw_experts = draw_experts
    tmodel.draw_noise = lambda shape, generator=None: noise.pop(0)
    tmodel.draw_uniform = lambda shape, generator=None: us.pop(0)
    out = tmodel.encode(data, list(subset), N=2, **HMC)
    assert experts == [(2, 8)] and not noise and not us
    assert out.z.shape == (2, 4, LATENT) and not out.z.requires_grad
    ratios = tmodel.last_hmc_ratios
    assert ratios.shape == (3, 8)
    np.testing.assert_array_equal((torch.stack(uniforms) < ratios).numpy().ravel(), accepts)
    np.testing.assert_allclose(out.z.numpy(), ref, **HMC_TOL)
    # K == 1 gives (n, D); flatten merges (N, n)
    del tmodel.draw_experts, tmodel.draw_noise, tmodel.draw_uniform
    assert tmodel.encode(data, list(subset), mcmc_steps=1, n_lf=1).z.shape == (4, LATENT)
    assert tmodel.encode(data, list(subset), N=3, flatten=True, mcmc_steps=1,
                         n_lf=1).z.shape == (12, LATENT)


def test_joint_nll_matches_jax(jmodel):
    tmodel = _port_model(jmodel)
    data = _arrays(seed=10)
    key = jax.random.key(11)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys = iter(chain(key, 3))
    tmodel.draw_noise = lambda shape, generator=None: normal(next(keys), shape)
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)


@pytest.mark.parametrize("custom", [False, True])
def test_save_and_reload(tmp_path, custom):
    """Default flows come back from the config and the weights; custom flows
    (an IAF per modality here) are pickled as a dict and given back."""
    flows = None          # the default MAFs
    if custom:
        flows = {m: IAF(LATENT, hidden_size=8) for m in DIMS}
        generator = torch.Generator().manual_seed(3)
        for f in flows.values():
            f.reset_parameters(generator)
    tmodel = _port_model(flows=flows)
    assert ("flows" in tmodel.model_config.custom_architectures) == custom
    tmodel.set_stage(2)
    tmodel.save(str(tmp_path))
    assert os.path.exists(tmp_path / "flows.pkl") == custom
    reloaded = JNF.load_from_folder(str(tmp_path), device="cpu")
    assert type(reloaded.flows["m1"]) is (IAF if custom else MAF)
    assert sorted(reloaded.model_config.custom_architectures) == sorted(
        tmodel.model_config.custom_architectures)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
    reloaded.set_stage(2)
    batch = batch_from_arrays(_arrays(seed=13))
    outs = []
    for model in (tmodel, reloaded):
        model.draw_noise = _keyed_noise(jax.random.key(2))
        with torch.no_grad():
            outs.append(model.loss_function(batch, StepInfo(epoch=3)).loss.item())
            outs.append(model.encode(batch, "m0").z)
    assert outs[0] == outs[2] and torch.equal(outs[1], outs[3])


def test_idle_weights_under_weight_decay_differ_from_jax(jmodel):
    """A limit kept on purpose (ROADMAP Queue C): in stage 1 the unimodal
    encoders and the flows get no gradient (in stage 2 the frozen joint
    encoder and decoders). optax steps them with zeros, so under weight
    decay (AdamW, decay 0.1, lr 1e-3) the JAX package shrinks each by a
    factor 1 - 1e-4 a step; their gradients are None in the port, and torch
    leaves them where they are."""
    tmodel = _port_model(jmodel)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    optimizer = make_optimizer("AdamW", tmodel.parameters(), 1e-3, {"weight_decay": 0.1})
    tmodel.loss_function(batch_from_arrays(_arrays()), StepInfo(epoch=1)).loss.backward()
    optimizer.step()
    after = tmodel.state_dict()
    idle = [k for k in before if k.startswith(("encoders.", "flows."))]
    assert idle and all(torch.equal(after[k], before[k]) for k in idle)
    assert not torch.equal(after["joint_encoder.dense.0.weight"],
                           before["joint_encoder.dense.0.weight"])
    # the JAX package's optimizer on the zero gradients of an idle flow and
    # encoder
    jopt = j_make_optimizer("AdamW", 1e-3, {"weight_decay": 0.1})
    idle_params = {"flows": {"m0": jmodel.params["flows"]["m0"]},
                   "encoders": {"m1": jmodel.params["encoders"]["m1"]}}

    @jax.jit
    def step(params):
        zeros = jax.tree.map(jnp.zeros_like, params)
        updates, _ = jopt.update(zeros, jopt.init(params), params)
        return optax.apply_updates(params, updates)

    moved = state_of(step(idle_params))
    assert len(moved) == 12 + 8          # a MAF of 2 x 3 layers, an MLP encoder of 4
    for k, v in moved.items():
        np.testing.assert_allclose(v.numpy(), before[k].numpy() * (1 - 1e-4), rtol=1e-6,
                                   atol=1e-12, err_msg=k)



class _ParamsAtLog(TrainingCallback):
    """The JAX trainer's live parameters at each epoch's log."""

    def __init__(self):
        self.trainer, self.logs, self.params = None, [], []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))
        self.params.append(state_of(self.trainer.state.params))


def test_multistage_curve_matches_jax_across_the_reset_and_flip(tmp_path):
    """Warm-up 1 over 3 epochs under Adam (lr 1e-3, StepLR halving the rate
    each epoch) on 20 rows in batches of 8 with a 16-row eval set: epoch 2
    starts stage 2 with the optimizer, the scheduler and the best losses
    reset, from the weights kept at epoch 1. The two trainers agree through
    stage 2: losses, live weights at each epoch and the kept weights. (The
    JAX trainer finalizes each epoch before the next, so that its log sees
    that epoch's weights.)"""
    data, eval_data = _arrays(seed=5, n=20), _arrays(seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls="Adam",
                  scheduler_cls="StepLR", scheduler_params={"step_size": 1, "gamma": 0.5})
    jmodel = _jax_model()
    tmodel = _port_model(jmodel)
    rec = _ParamsAtLog()
    jtrainer = JMultistageTrainer(
        jmodel, JDataset(data), JDataset(eval_data), callbacks=[rec],
        training_config=JMultistageTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                 n_devices=1, pipeline_epochs=False,
                                                 **common))
    rec.trainer = jtrainer
    jtrainer.train()

    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = MultistageTrainer(tmodel, MultimodalBaseDataset(data),
                                MultimodalBaseDataset(eval_data), device="cpu",
                                training_config=MultistageTrainerConfig(
                                    output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, _keyed_noise, SEED)
    first_optimizer, lrs, stages, states = trainer.optimizer, [], [], []
    train_step, finalize = trainer.train_step, trainer._finalize_epoch

    def train_step_logged(epoch):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        stages.append(tmodel.current_stage)
        return train_step(epoch)

    def finalize_logged(*args):
        finalize(*args)
        states.append({k: v.clone() for k, v in tmodel.state_dict().items()})

    trainer.train_step, trainer._finalize_epoch = train_step_logged, finalize_logged
    trainer.train()
    assert next(steps) == 3 * 3
    assert trainer.optimizer is not first_optimizer and stages == [1, 2, 2]
    # the reset and the flip in the same epoch: the rate restarts at epoch 2
    assert lrs == [1e-3, 1e-3, 5e-4]
    jlr = float(jtrainer.state.opt_state.hyperparams["learning_rate"])
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(jlr) == 2.5e-4
    assert set(trainer.history[2]) >= {"train_ljm", "eval_ljm", "eval_kld_prior"}
    for key in ("train_epoch_loss", "eval_epoch_loss", "train_ljm", "eval_recon_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    for epoch in range(3):
        assert_same_moves(states[epoch], rec.params[epoch], start, 1e-3)
    # stage 2 leaves the joint encoder and the decoders where epoch 1 left
    # them, in both packages
    frozen = [k for k in start if k.startswith(FROZEN)]
    assert frozen and all(torch.equal(states[2][k], states[0][k]) for k in frozen)
    for k in frozen:
        np.testing.assert_array_equal(rec.params[2][k].numpy(), rec.params[0][k].numpy())
    assert trainer.best_eval_loss == pytest.approx(jtrainer.best_eval_loss, rel=1e-4)
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
