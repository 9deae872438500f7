"""The port's CVAE against the JAX package's, on the CPU at the tutorial's
shapes (``examples/tutorials/training_a_cvae_model.py``: a target of 12,
conditions of 6 and 1x4x4, latent 8) with the default nets (a joint
encoder over MLP encoders of every modality, a conditional MLP decoder),
with and without a prior network, batch 8.

Weights cross with ``params_from_jax`` (the ``encoder``, ``decoder`` and
``prior_network`` groups); noise is ``jax.random.normal`` of each call's
key. Compared: the batch-mean loss, its metrics and every gradient;
encode, decode, generate_from_prior and both predict paths; save and
reload with custom single-module architectures, and the reload of the
default encoder, whose modalities come back in the sorted order of the
config JSON in both packages; the config JSON round trip; and a 3-epoch
``BaseTrainer`` curve against the JAX trainer.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import CVAE as JCVAE
from multivae_tpu.models import CVAEConfig as JCVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import BaseDictEncoders as JBaseDictEncoders
from multivae_tpu.nn import MultipleHeadJointEncoder as JJointEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import CVAE, CVAEConfig
from multivae_tpu_torch.nn import (
    BaseAEConfig,
    BaseDictEncoders,
    ConditionalDecoderMLP,
    MultipleHeadJointEncoder,
)
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import Recorder, assert_same_moves, feed_trainer_noise, normal, state_of

torch.set_num_threads(2)

DIMS = {"target": (12,), "cond_a": (6,), "cond_b": (1, 4, 4)}
COND = ["cond_a", "cond_b"]
LATENT, B, SEED = 8, 8, 11
# The loss is a batch mean of sums of ~10^2 float32 terms, taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients go through the
# joint encoder's 5 layers: 1e-4 relative, with an absolute floor of 1e-6.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config(**extra):
    kw = dict(main_modality="target", conditioning_modalities=list(COND),
              input_dims=DIMS, latent_dim=LATENT, beta=1.5)
    kw.update(extra)
    return kw


def _models(prior=True, **extra):
    cond_dims = {m: DIMS[m] for m in COND}
    jprior = (JJointEncoder(dict_encoders=JBaseDictEncoders(cond_dims, LATENT),
                            args=JAEConfig(latent_dim=LATENT)) if prior else None)
    jmodel = JCVAE(JCVAEConfig(**_config(**extra)), prior_network=jprior, seed=0)
    tprior = (MultipleHeadJointEncoder(BaseDictEncoders(cond_dims, LATENT),
                                       BaseAEConfig(latent_dim=LATENT)) if prior else None)
    tmodel = CVAE(CVAEConfig(**_config(**extra)), prior_network=tprior, device="cpu")
    tmodel.load_state_dict(state_of(jmodel.params))
    return jmodel, tmodel


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {"target": rng.normal(size=(n, 12)).astype(np.float32),
            "cond_a": rng.normal(size=(n, 6)).astype(np.float32),
            "cond_b": rng.uniform(size=(n, 1, 4, 4)).astype(np.float32)}


def _keyed_noise(key):
    return lambda shape, generator=None: normal(key, shape)


@pytest.mark.parametrize("prior", [True, False], ids=["prior_network", "std_prior"])
def test_loss_metrics_and_every_gradient_match_jax(prior):
    jmodel, tmodel = _models(prior)
    assert tmodel.model_config.custom_architectures == (["prior_network"] if prior else [])
    data = _arrays()
    weights = np.ones(B, np.float32)
    weights[-1] = 0.0            # a loader padding row
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, weights=weights)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, JStepInfo.create(epoch=1))
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    tmodel.draw_noise = _keyed_noise(key)
    out = tmodel.loss_function(batch_from_arrays(data=data, weights=weights))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"kl", "recon_loss"}
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    assert any(n.startswith("decoder.network.") for n in grads)
    for name, g in grads.items():
        # joint encoders read their encoders' embeddings only: the
        # log-variance heads get no gradient (None here, zeros in JAX)
        if g is None:
            assert ".dict_encoders." in name and ".dense.3." in name, name
            assert not ref_grads[name].any(), name
            continue
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("prior", [True, False], ids=["prior_network", "std_prior"])
def test_inference_matches_jax(prior):
    jmodel, tmodel = _models(prior)
    data = _arrays(seed=3)
    key = jax.random.key(4)
    cond = {m: data[m] for m in COND}
    with torch.no_grad():
        for N, flatten, mean in ((1, False, False), (3, False, False), (3, True, False),
                                 (2, False, True)):
            ref = jmodel.encode(data, N=N, flatten=flatten, return_mean=mean, rng=key)
            tmodel.draw_noise = _keyed_noise(key)
            out = tmodel.encode(data, N=N, flatten=flatten, return_mean=mean)
            assert out.z.shape == ref.z.shape
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            for m in COND:
                assert out.cond_mod_data[m].shape == ref.cond_mod_data[m].shape
            rec, jrec = tmodel.decode(out), jmodel.decode(ref)
            assert rec.reconstruction.shape == jrec.reconstruction.shape
            np.testing.assert_allclose(rec.reconstruction.numpy(),
                                       np.asarray(jrec.reconstruction), **VALUE_TOL)

            ref = jmodel.generate_from_prior(cond, N=N, flatten=flatten, rng=key)
            out = tmodel.generate_from_prior(cond, N=N, flatten=flatten)
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)

        for cond_mod in ("all", ["target"], list(COND)):
            ref = jmodel.predict(data, cond_mod=cond_mod, N=2, rng=key)
            out = tmodel.predict(data, cond_mod=cond_mod, N=2)
            assert out.target.shape == (2, B, 12) == ref.target.shape
            np.testing.assert_allclose(out.target.numpy(), np.asarray(ref.target),
                                       **VALUE_TOL)
    with pytest.raises(ValueError, match="conditioning modalities"):
        tmodel.predict(data, cond_mod=["cond_a"])


def test_save_and_reload_custom_single_module_architectures(tmp_path):
    """A custom encoder, decoder and prior network, each a single module,
    are saved whole and given back as modules: the reloaded model computes
    the same loss."""
    cond_dims = {m: DIMS[m] for m in COND}
    model = CVAE(CVAEConfig(**_config()),
                 encoder=MultipleHeadJointEncoder(BaseDictEncoders(DIMS, LATENT),
                                                  BaseAEConfig(latent_dim=LATENT),
                                                  hidden_dim=24),
                 decoder=ConditionalDecoderMLP(LATENT, DIMS["target"], cond_dims),
                 prior_network=MultipleHeadJointEncoder(
                     BaseDictEncoders(cond_dims, LATENT), BaseAEConfig(latent_dim=LATENT),
                     hidden_dim=32),
                 seed=2, device="cpu")
    custom = ["encoder", "decoder", "prior_network"]
    assert model.model_config.custom_architectures == custom
    model.save(str(tmp_path))
    for name, cls in (("encoder", MultipleHeadJointEncoder),
                      ("decoder", ConditionalDecoderMLP),
                      ("prior_network", MultipleHeadJointEncoder)):
        assert isinstance(torch.load(os.path.join(tmp_path, f"{name}.pkl"),
                                     weights_only=False), cls)
    reloaded = CVAE.load_from_folder(str(tmp_path), device="cpu")
    assert reloaded.encoder.dense[0].out_features == 24
    assert reloaded.prior_network.dense[0].out_features == 32
    assert sorted(reloaded.model_config.custom_architectures) == sorted(custom)
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
    data = _arrays(seed=5)
    key = jax.random.key(6)
    for m in (model, reloaded):
        m.draw_noise = _keyed_noise(key)
    with torch.no_grad():
        assert model(data).loss.item() == reloaded(data).loss.item()


def test_reloaded_default_encoder_takes_sorted_modalities_like_jax(tmp_path):
    """Both packages write the config JSON with sorted keys, and the default
    joint encoder concatenates its modalities in ``input_dims`` order: the
    tutorial's order (target first) comes back sorted, so a reloaded model
    with the default encoder computes another loss, in both packages."""
    jmodel, tmodel = _models()
    data = _arrays(seed=5)
    key = jax.random.key(6)
    jmodel.save(str(tmp_path / "jax"))
    jreloaded = JCVAE.load_from_folder(str(tmp_path / "jax"))
    tmodel.save(str(tmp_path / "torch"))
    treloaded = CVAE.load_from_folder(str(tmp_path / "torch"), device="cpu")
    assert list(treloaded.encoder.dict_encoders) == sorted(DIMS) != list(DIMS)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(treloaded.state_dict()[k], v), k
    losses = {}
    for name, model in (("jax", jmodel), ("jax_reloaded", jreloaded)):
        losses[name] = float(model.forward(data, rng=key).loss)
    for name, model in (("torch", tmodel), ("torch_reloaded", treloaded)):
        model.draw_noise = _keyed_noise(key)
        with torch.no_grad():
            losses[name] = model(data).loss.item()
    np.testing.assert_allclose(losses["torch"], losses["jax"], **LOSS_TOL)
    np.testing.assert_allclose(losses["torch_reloaded"], losses["jax_reloaded"], **LOSS_TOL)
    assert abs(losses["jax_reloaded"] - losses["jax"]) > 1e-3


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config(decoder_dist="laplace", decoder_dist_params={"scale": 0.5})
    jcfg, tcfg = JCVAEConfig(**kw), CVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert CVAEConfig().to_dict() == JCVAEConfig().to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert CVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "CVAEConfig"
    assert JCVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg
    with pytest.raises(ValueError, match="decoder_dist"):
        CVAEConfig(decoder_dist="poisson")


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3) on 20 rows in batches of 8 (the
    last one padded), with the prior network, against the JAX trainer: the
    same weights, batch order and noise; the epoch losses and metrics and
    the final weights (no eval set: both keep the live ones)."""
    data = _arrays(seed=7, n=20)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  seed=SEED, optimizer_cls="Adam")
    jmodel, tmodel = _models()
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JDataset(data), callbacks=[rec],
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common))
    jtrainer.train()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, _keyed_noise, SEED)
    trainer.train()
    assert next(steps) == 3 * 3
    for key in ("train_epoch_loss", "train_kl", "train_recon_loss"):
        np.testing.assert_allclose([h[key] for h in trainer.history],
                                   [h[key] for h in rec.logs], rtol=1e-4, err_msg=key)
    assert trainer._best_state is None
    assert_same_moves(tmodel.state_dict(), state_of(jtrainer.best_params), start, 1e-3)
    assert os.path.exists(os.path.join(trainer.training_dir, "final_model",
                                       "prior_network.pkl"))
