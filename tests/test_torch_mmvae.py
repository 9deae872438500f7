"""The port's MMVAE slice against the JAX package, at a small size
(3 modalities, latent 8, hidden 16, K=4, batch 16), on the CPU.

Weights cross with ``params_from_jax``; the Laplace/Normal noise is drawn
with ``jax.random`` and fed to both sides, so the two compute the same
function of the same numbers. Compared: the loss and every parameter
gradient of both objectives, one Adam step, and a 3-epoch ``BaseTrainer``
loss curve with the JAX trainer's own noise.
"""

import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import MMVAE, MMVAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops.kdist import dist_rsample_k
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import LAPLACE_LOW, normal, uniform

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
LATENT, HID, K, B = 8, 16, 4, 16
DEC_DISTS = {"m0": "laplace", "m1": "laplace", "m2": "normal"}
SEED = 11
# Losses are sums of ~10^2-10^3 float32 terms taken in another order by
# XLA and by PyTorch: 1e-5 relative. Gradients add the DReG/IWAE weights
# exp(lw - logsumexp lw), whose relative error is the absolute error of lw
# (~1e-4 at |lw| ~ 10^2): 1e-4 relative, with an absolute floor for
# entries that cancel to near zero.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _config_kwargs(dist, loss):
    return dict(n_modalities=len(DIMS), latent_dim=LATENT, input_dims=DIMS, K=K,
                prior_and_posterior_dist=dist, loss=loss, learn_prior=True,
                uses_likelihood_rescaling=True, decoders_dist=dict(DEC_DISTS))


def _jax_model(dist="laplace_with_softmax", loss="dreg_looser", seed=0):
    enc = {m: JEncoder(JAEConfig(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
           for m, d in DIMS.items()}
    dec = {m: JDecoder(JAEConfig(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
           for m, d in DIMS.items()}
    model = JMMVAE(JMMVAEConfig(**_config_kwargs(dist, loss)), encoders=enc,
                   decoders=dec, seed=seed)
    # a non-trivial prior so its gradient path is exercised
    model.params["model"]["prior_log_var"] = jnp.asarray(
        np.random.default_rng(seed).normal(size=(1, LATENT)).astype(np.float32) * 0.3)
    return model


def _port_model(jmodel, dist="laplace_with_softmax", loss="dreg_looser"):
    enc = {m: Encoder_VAE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT),
                              hidden_dim=HID) for m, d in DIMS.items()}
    dec = {m: Decoder_AE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT),
                             hidden_dim=HID) for m, d in DIMS.items()}
    model = MMVAE(MMVAEConfig(**_config_kwargs(dist, loss)), encoders=enc,
                  decoders=dec, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return model


def _batch_arrays(seed=0):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(B, *d)).astype(np.float32) for m, d in DIMS.items()}
    masks = {m: (rng.uniform(size=B) > 0.25).astype(np.float32) for m in DIMS}
    masks["m0"][:3] = 1.0
    masks["m1"][:3] = 0.0        # rows with a missing modality...
    masks["m2"][3] = 0.0
    masks["m1"][3] = 0.0         # ...and with two
    weights = np.ones(B, np.float32)
    weights[-2:] = 0.0           # loader padding rows
    return data, masks, weights


def _noise(dist, seed=0):
    key = jax.random.key(seed)
    shape = (K, B, LATENT)
    out = {}
    for i, m in enumerate(DIMS):
        k = jax.random.fold_in(key, i)
        u = uniform(k, shape, LAPLACE_LOW, 0.5) if dist == "laplace_with_softmax" \
            else normal(k, shape)
        out[m] = u.numpy()
    return out


@pytest.fixture(scope="module")
def jax_models():
    """``_jax_model(dist, loss)`` made once for the tests that only read it,
    which then share its compiles."""
    models = {}

    def get(dist="laplace_with_softmax", loss="dreg_looser"):
        if (dist, loss) not in models:
            models[dist, loss] = _jax_model(dist, loss)
        return models[dist, loss]

    return get


def _jax_loss_and_grads(jmodel, objective, arrays, u, dist, params=None):
    """The JAX loss and every gradient at ``params`` (default the model's),
    compiled once per model and objective in the model's own jit cache."""
    data, masks, weights = arrays
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)

    def loss(params, batch, u):
        post = jmodel._posterior_params(params, batch)
        zs = {}
        for m, (mu, sigma) in post.items():
            if dist == "laplace_with_softmax":
                zs[m] = mu - sigma * jnp.sign(u[m]) * jnp.log1p(-2.0 * jnp.abs(u[m]))
            else:
                zs[m] = mu + sigma * u[m]
        return getattr(jmodel, objective)(params, batch, post, zs).loss

    fn = jmodel._jit(("test_value_and_grad", objective, dist), jax.value_and_grad(loss))
    value, grads = fn(jmodel.params if params is None else params, batch, u)
    return float(value), params_from_jax(jax.tree.map(np.asarray, grads))


def _port_loss(tmodel, objective, arrays, u):
    data, masks, weights = arrays
    batch = batch_from_arrays(data=data, masks=masks, weights=weights)
    post = tmodel._posterior_params(batch)
    zs = {m: dist_rsample_k(tmodel.dist_name, mu, sigma, K, u=torch.tensor(u[m]))
          for m, (mu, sigma) in post.items()}
    return getattr(tmodel, objective)(batch, post, zs).loss


@pytest.mark.parametrize("objective", ["_dreg_looser", "_iwae_looser"])
@pytest.mark.parametrize("dist", ["laplace_with_softmax", "normal"])
def test_loss_and_every_gradient_match_jax(jax_models, objective, dist):
    loss_name = objective.strip("_")
    jmodel = jax_models(dist, loss_name)
    tmodel = _port_model(jmodel, dist, loss_name)
    arrays, u = _batch_arrays(), _noise(dist)
    ref_loss, ref_grads = _jax_loss_and_grads(jmodel, objective, arrays, u, dist)

    loss = _port_loss(tmodel, objective, arrays, u)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, **LOSS_TOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_one_adam_step_matches_jax(jax_models):
    jmodel = jax_models()
    tmodel = _port_model(jmodel)
    arrays, u = _batch_arrays(seed=1), _noise("laplace_with_softmax", seed=1)
    lr = 1e-2

    _, grads = _jax_loss_and_grads(jmodel, "_dreg_looser", arrays, u,
                                   "laplace_with_softmax")
    opt = optax.adam(lr)
    jgrads = jax.tree.map(jnp.asarray, _unflatten_like(jmodel.params, grads))
    updates, _ = jax.jit(opt.update)(jgrads, opt.init(jmodel.params), jmodel.params)
    stepped = optax.apply_updates(jmodel.params, updates)
    ref_after, _ = _jax_loss_and_grads(jmodel, "_dreg_looser", arrays, u,
                                       "laplace_with_softmax", params=stepped)

    optim = torch.optim.Adam(tmodel.parameters(), lr=lr)
    _port_loss(tmodel, "_dreg_looser", arrays, u).backward()
    optim.step()
    expected = params_from_jax(jax.tree.map(np.asarray, stepped))
    for name, p in tmodel.named_parameters():
        # one Adam step moves each weight by ~lr * g/|g|; g's 1e-4 relative
        # error moves that by < 1e-6 except where |g| ~ eps (1e-8)
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(),
                                   rtol=0, atol=2e-6, err_msg=name)
    with torch.no_grad():
        after = _port_loss(tmodel, "_dreg_looser", arrays, u).item()
    np.testing.assert_allclose(after, ref_after, **LOSS_TOL)


def _unflatten_like(params, state):
    """Port state_dict (torch names) -> the JAX nested tree layout."""
    tree = jax.tree.map(lambda x: x, params)
    for group in ("encoders", "decoders"):
        for m, layers in tree[group].items():
            for layer in layers:
                i = int(layer.split("_")[1])
                prefix = f"{group}.{m}.dense.{i}"
                layers[layer] = {
                    "kernel": state[prefix + ".weight"].numpy().T,
                    "bias": state[prefix + ".bias"].numpy(),
                }
    tree["model"] = {k: state[k].numpy() for k in tree["model"]}
    return tree


class _Recorder(TrainingCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, training_config, logs, **kwargs):
        self.losses.append(logs["train_epoch_loss"])


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3, StepLR) on 40 rows in batches of
    16 (the last one padded) vs the JAX trainer, same weights, same batch
    order, and the port's noise source patched to return the JAX trainer's
    draws: ``fold_in(key(seed), step)`` split over the modalities."""
    rng = np.random.default_rng(3)
    data = {m: rng.uniform(size=(40, *d)).astype(np.float32) for m, d in DIMS.items()}
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=16,
                  seed=SEED, optimizer_cls="Adam", scheduler_cls="StepLR",
                  scheduler_params={"step_size": 2, "gamma": 0.5})
    jmodel = _jax_model()
    tmodel = _port_model(jmodel)

    rec = _Recorder()
    JTrainer(jmodel, JDataset(data), training_config=JTrainerConfig(
        output_dir=str(tmp_path / "jax"), n_devices=1, **common),
        callbacks=[rec]).train()

    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    calls = itertools.count()

    def jax_trainer_noise(shape, generator=None):
        step, i = divmod(next(calls), len(DIMS))
        key = jax.random.fold_in(jax.random.key(SEED), step)
        key = jax.random.split(key, len(DIMS))[i]
        return uniform(key, shape, LAPLACE_LOW, 0.5)

    tmodel.draw_noise = jax_trainer_noise
    trainer.train()
    ours = [h["train_epoch_loss"] for h in trainer.history]
    assert next(calls) == 3 * 3 * len(DIMS)   # 3 epochs x 3 steps x 3 mods
    # float32 drift over 9 Adam steps of two implementations
    np.testing.assert_allclose(ours, rec.losses, rtol=1e-4)


def test_trainer_best_on_eval_and_final_save(tmp_path):
    rng = np.random.default_rng(4)
    data = {m: rng.uniform(size=(24, *d)).astype(np.float32) for m, d in DIMS.items()}
    model = MMVAE(MMVAEConfig(**_config_kwargs("laplace_with_softmax",
                                               "dreg_looser")), device="cpu")
    trainer = BaseTrainer(model, MultimodalBaseDataset(data),
                          MultimodalBaseDataset(data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path), num_epochs=2,
                              learning_rate=1e-3,
                              per_device_train_batch_size=8,
                              per_device_eval_batch_size=8))
    trainer.train()
    evals = [h["eval_epoch_loss"] for h in trainer.history]
    assert len(evals) == 2 and np.isfinite(evals).all()
    assert trainer.best_eval_loss == min(evals)
    final = os.path.join(trainer.training_dir, "final_model")
    for f in ("model.pt", "model_config.json", "environment.json",
              "training_config.json"):
        assert os.path.exists(os.path.join(final, f))
    reloaded = MMVAE.load_from_folder(final, device="cpu")
    for k, v in trainer._best_state.items():
        assert torch.equal(reloaded.state_dict()[k], v)


def test_trainer_nan_guard(tmp_path):
    data = {m: np.full((8, *d), np.nan, np.float32) for m, d in DIMS.items()}
    model = MMVAE(MMVAEConfig(**_config_kwargs("laplace_with_softmax",
                                               "dreg_looser")), device="cpu")
    trainer = BaseTrainer(model, MultimodalBaseDataset(data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path), num_epochs=1,
                              per_device_train_batch_size=8))
    with pytest.raises(ArithmeticError, match="NaN"):
        trainer.train()


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs("normal", "iwae_looser")
    jcfg, tcfg = JMMVAEConfig(**kw), MMVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    path = str(tmp_path / "model_config.json")
    assert MMVAEConfig.from_json_file(path) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "MMVAEConfig"
    assert JMMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_trainer_config_validates_optimizer_specs():
    with pytest.raises(AttributeError):
        BaseTrainerConfig(optimizer_cls="Lion")
    with pytest.raises(TypeError):
        BaseTrainerConfig(optimizer_params={"momentum": 0.9})
    cfg = BaseTrainerConfig(optimizer_params={"b1": 0.8, "b2": 0.99})
    assert cfg.optimizer_params == {"b1": 0.8, "b2": 0.99}
    with pytest.raises(AttributeError):
        BaseTrainerConfig(scheduler_cls="Cyclic")


def test_model_constructor_checks():
    kw = _config_kwargs("laplace_with_softmax", "dreg_looser")
    enc = {m: Encoder_VAE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT))
           for m, d in DIMS.items()}
    with pytest.raises(AttributeError, match="number of encoders"):
        MMVAE(MMVAEConfig(**kw), encoders=dict(list(enc.items())[:2]), device="cpu")
    with pytest.raises(ValueError):
        MMVAEConfig(**{**kw, "prior_and_posterior_dist": "normal_with_softplus"})
    with pytest.raises(AttributeError, match="input_dims"):
        MMVAE(MMVAEConfig(**{**kw, "n_modalities": 2}), device="cpu")


def test_default_nets_are_seeded_and_forward_runs():
    kw = _config_kwargs("laplace_with_softmax", "dreg_looser")
    a = MMVAE(MMVAEConfig(**kw), seed=3, device="cpu")
    b = MMVAE(MMVAEConfig(**kw), seed=3, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    data, masks, _ = _batch_arrays()
    out = a({"data": data, "masks": masks},
            generator=torch.Generator().manual_seed(0))
    assert out.loss.shape == () and torch.isfinite(out.loss)
    assert out.loss_sum is out.loss


def test_inference_methods_run_like_jax():
    """The inference methods run where the JAX package runs them."""
    model = MMVAE(MMVAEConfig(**_config_kwargs("laplace_with_softmax",
                                               "dreg_looser")), device="cpu")
    data, _, _ = _batch_arrays()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert model.encode(data, generator=gen).z.shape == (B, LATENT)
        assert model.predict(data, cond_mod="m0", generator=gen)["m1"].shape == (B, 6)
        assert model.generate_from_prior(2, generator=gen).z.shape == (2, LATENT)
    assert model.compute_joint_nll(data, K=2, generator=gen).shape == ()


def test_inference_refuses_like_jax():
    """What the JAX package has not implemented raises in the port too (the
    joint NLL of incomplete data), as does what it refuses (an incomplete
    or unknown conditioning subset)."""
    model = MMVAE(MMVAEConfig(**_config_kwargs("laplace_with_softmax",
                                               "dreg_looser")), device="cpu")
    data, masks, _ = _batch_arrays()
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        model.compute_joint_nll(_Masked(data, masks), K=2)
    with pytest.raises(AttributeError, match="incomplete dataset"):
        model.encode(_Masked(data, masks), cond_mod="m1")
    with pytest.raises(AttributeError, match="neither"):
        model.encode(data, cond_mod="m9")


class _Masked:
    """A dataset-like input with masks (``encode`` checks them)."""

    def __init__(self, data, masks):
        self.data, self.masks = data, masks


# Inference: latent samples and decoder outputs are elementwise functions of
# the same noise (a few ulps of O(1)); the NLLs are sums like the losses.
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


class _JaxDraws:
    """``draw_noise`` / ``draw_expert`` hooks returning the JAX package's
    draws: the Laplace noise ``uniform(key, shape, -0.5 + eps, 0.5)`` of
    each key in ``keys`` in turn, and the expert index ``randint(key, (), 0,
    n)`` of ``expert_key``."""

    def __init__(self, keys, expert_key=None):
        self.keys, self.expert_key, self.shapes = list(keys), expert_key, []

    def noise(self, shape, generator=None):
        self.shapes.append(tuple(shape))
        key = self.keys.pop(0)
        return uniform(key, shape, LAPLACE_LOW, 0.5)

    def expert(self, n, generator=None):
        return int(jax.random.randint(self.expert_key, (), 0, n))

    def install(self, model):
        model.draw_noise, model.draw_expert = self.noise, self.expert
        return self


def _chain(key, n):
    """The keys ``lax.scan`` hands out: the carry split once per chunk."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_encode_predict_generate_match_jax(jax_models):
    jmodel = jax_models()
    tmodel = _port_model(jmodel)
    data, _, _ = _batch_arrays(seed=5)
    key = jax.random.key(6)
    _, choice, sample = jax.random.split(key, 3)
    cond = ["m0", "m2"]
    with torch.no_grad():
        for N, flatten, mean, shape in ((3, True, False, (3 * B, LATENT)),
                                        (3, False, False, (3, B, LATENT)),
                                        (1, False, False, (B, LATENT)),
                                        (2, False, True, (2, B, LATENT))):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            draws = _JaxDraws([sample], choice).install(tmodel)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            assert draws.keys == ([sample] if mean else [])
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=cond, gen_mod="all", N=3, rng=key)
        _JaxDraws([sample], choice).install(tmodel)
        out = tmodel.predict(data, cond_mod=cond, gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), **VALUE_TOL)

        for n_samples, shape in ((5, (5, LATENT)), (1, (LATENT,))):
            ref = jmodel.generate_from_prior(n_samples, rng=key)
            _JaxDraws([key]).install(tmodel)
            out = tmodel.generate_from_prior(n_samples)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            rec, jrec = tmodel.decode(out, "m2"), jmodel.decode(ref, "m2")
            np.testing.assert_allclose(rec["m2"].numpy(), np.asarray(jrec["m2"]),
                                       **VALUE_TOL)


def test_joint_nll_matches_jax(jax_models):
    jmodel = jax_models()
    tmodel = _port_model(jmodel)
    data, _, _ = _batch_arrays(seed=7)
    key = jax.random.key(8)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    rest, choice = jax.random.split(key)
    draws = _JaxDraws(_chain(rest, 3), choice).install(tmodel)
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert draws.shapes == [(3, B, LATENT), (3, B, LATENT), (1, B, LATENT)]
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)


def test_joint_nll_paper_matches_jax(jax_models):
    jmodel = jax_models()
    tmodel = _port_model(jmodel)
    data, _, _ = _batch_arrays(seed=9)
    key = jax.random.key(10)
    K, chunk = 5, 2                       # chunks of 2, 2 and 1
    ref = np.asarray(jmodel.compute_joint_nll_paper(data, K=K, batch_size_K=chunk,
                                                    rng=key))
    keys = [k for sub in _chain(key, 3) for k in jax.random.split(sub, len(DIMS))]
    draws = _JaxDraws(keys).install(tmodel)
    out = tmodel.compute_joint_nll_paper(data, K=K, batch_size_K=chunk)
    assert draws.shapes == [(n, B, LATENT) for n in (2, 2, 1) for _ in DIMS]
    assert out.shape == (B,) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **LOSS_TOL)
