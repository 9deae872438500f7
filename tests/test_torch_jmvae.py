"""The port's JMVAE and BaseJointModel against the JAX package's, on the CPU
at a small size: 3 modalities on the MLP nets (hidden 16), latent 8, batch
8, the default joint encoder (its own copies of the encoders, fusion width
512) or a narrow custom one.

Weights cross with ``params_from_jax`` (the ``joint_encoder`` group with
its nested encoder copies); the noise of every call is the JAX package's
``jax.random.normal`` of its key, handed to the port through ``draw_noise``.
Compared: the loss, ``loss_sum``, every metric and every gradient inside
and after the warm-up and with a padding row; every encode path (joint
encoder, one encoder, the PoE of a subset), predict and
generate_from_prior; the joint NLL; the refusal of incomplete data; save
and reload with a custom joint encoder; the config JSON round trip; and a
3-epoch ``BaseTrainer`` curve with an eval set against the JAX trainer,
inside and past the keep-best window (``start_keep_best_epoch = warmup +
1``), with the kept weights and the best eval loss.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import JMVAE as JJMVAE
from multivae_tpu.models import JMVAEConfig as JJMVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.nn import MultipleHeadJointEncoder as JJointEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import JMVAE, JMVAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import (
    BaseAEConfig,
    Decoder_AE_MLP,
    Encoder_VAE_MLP,
    MultipleHeadJointEncoder,
)
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import (
    Recorder,
    assert_same_moves,
    chain,
    feed_trainer_noise,
    normal,
    port_model,
    state_of,
)

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED = 8, 16, 8, 11
# Losses and metrics are sums of 10^2-10^3 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through 4 to 6 layers: 1e-4 relative, with an absolute floor of
# 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(**extra):
    kw = dict(n_modalities=len(DIMS), latent_dim=LATENT, input_dims=DIMS,
              uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
              decoder_dist_params={"m2": {"scale": 0.75}}, alpha=0.3, beta=1.5, warmup=4)
    kw.update(extra)
    return kw


def _models(custom_joint=False, **extra):
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    jencoders = {m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()}
    jjoint = (JJointEncoder(dict_encoders=jencoders, args=JAEConfig(latent_dim=LATENT),
                            hidden_dim=HID) if custom_joint else None)
    jmodel = JJMVAE(JJMVAEConfig(**_config_kwargs(**extra)), encoders=jencoders,
                    decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                    joint_encoder=jjoint, seed=0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    encoders = {m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()}
    joint = (MultipleHeadJointEncoder(encoders, BaseAEConfig(latent_dim=LATENT),
                                      hidden_dim=HID) if custom_joint else None)
    tmodel = JMVAE(JMVAEConfig(**_config_kwargs(**extra)), encoders=encoders,
                   decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                   joint_encoder=joint, device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


def _keyed_noise(key):
    return lambda shape, generator=None: normal(key, shape)


# (epoch, warmup, padded)
CASES = {"in_warmup": (1, 4, False), "after_warmup": (5, 4, False),
         "no_warmup_padded": (1, 0, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_metrics_and_every_gradient_match_jax(case):
    epoch, warmup, padded = CASES[case]
    jmodel, tmodel = _models(warmup=warmup)
    data = _arrays()
    weights = np.ones(B, np.float32)
    if padded:
        weights[-1] = 0.0
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, weights=weights)
    step = JStepInfo.create(epoch=epoch, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    shapes = []

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return normal(key, shape)

    tmodel.draw_noise = noise
    out = tmodel.loss_function(batch_from_arrays(data=data, weights=weights),
                               StepInfo(epoch=epoch, dataset_size=B))
    out.loss.backward()
    assert shapes == [(B, LATENT)]
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"loss_no_ponderation", "beta", "elbo"}
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    expected_beta = 1.0 if epoch >= warmup else epoch / warmup
    assert out.metrics["beta"].item() == pytest.approx(expected_beta)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    assert any(n.startswith("joint_encoder.dict_encoders.m2.") for n in grads)
    # the joint encoder reads its copies' embeddings only: their
    # log-variance heads get no gradient (None here, zeros in JAX)
    unused = {n for n, g in grads.items() if g is None}
    assert unused == {f"joint_encoder.dict_encoders.{m}.dense.3.{p}" for m in DIMS
                      for p in ("weight", "bias")}
    for name in unused:
        assert not ref_grads[name].any(), name
        grads[name] = torch.zeros_like(ref_grads[name])
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_joint_encoder_is_not_tied_to_the_encoders():
    """The default joint encoder holds copies of the encoders with weights of
    their own (as in the JAX package): its copy of m0 has other weights."""
    _, tmodel = _models()
    assert tmodel.model_config.custom_architectures == ["encoders", "decoders"]
    copy_w = tmodel.joint_encoder.dict_encoders["m0"].dense[0].weight
    assert copy_w is not tmodel.encoders["m0"].dense[0].weight
    assert not torch.equal(copy_w, tmodel.encoders["m0"].dense[0].weight)


def test_encode_predict_generate_match_jax():
    jmodel, tmodel = _models()
    data = _arrays(seed=6)
    key = jax.random.key(7)
    with torch.no_grad():
        for cond, N, flatten, mean, shape in (
                ("all", 3, True, False, (3 * B, LATENT)),
                (["m1"], 3, False, False, (3, B, LATENT)),
                (["m0", "m2"], 1, False, False, (B, LATENT)),
                (["m2", "m0"], 2, False, True, (2, B, LATENT)),
                ("all", 1, False, True, (B, LATENT))):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            tmodel.draw_noise = _keyed_noise(key)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), err_msg=str(cond),
                                       **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=["m0", "m1"], gen_mod="all", N=3, rng=key)
        out = tmodel.predict(data, cond_mod=["m0", "m1"], gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)
        ref = jmodel.generate_from_prior(5, rng=key)
        out = tmodel.generate_from_prior(5)
        np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
        rec, jrec = tmodel.decode(out, "m2"), jmodel.decode(ref, "m2")
        np.testing.assert_allclose(rec["m2"].numpy(), np.asarray(jrec["m2"]), **VALUE_TOL)


def test_joint_nll_matches_jax():
    jmodel, tmodel = _models()
    data = _arrays(seed=10)
    key = jax.random.key(11)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys, shapes = iter(chain(key, 3)), []

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return normal(next(keys), shape)

    tmodel.draw_noise = noise
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert shapes == [(3, B, LATENT), (3, B, LATENT), (1, B, LATENT)]
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)


def test_incomplete_data_is_refused_like_jax():
    jmodel, tmodel = _models()
    data = _arrays(seed=12)
    masks = {m: np.ones(B, np.float32) for m in DIMS}
    masks["m1"][2] = 0.0
    for model, dataset in ((jmodel, JIncompleteDataset(data, masks)),
                           (tmodel, IncompleteDataset(data, masks))):
        for call in (lambda: model.forward(dataset[:]),
                     lambda: model.encode(dataset[:], "m0"),
                     lambda: model.compute_joint_nll(dataset[:], K=4)):
            with pytest.raises(AttributeError, match="not compatible with incomplete"):
                call()


def test_save_and_reload_with_a_custom_joint_encoder(tmp_path):
    """A single-module custom architecture (the joint encoder) is saved whole
    and given back as a module; the reloaded model computes the same loss."""
    _, tmodel = _models(custom_joint=True)
    assert tmodel.model_config.custom_architectures == ["encoders", "decoders",
                                                        "joint_encoder"]
    tmodel.save(str(tmp_path))
    saved = torch.load(os.path.join(tmp_path, "joint_encoder.pkl"), weights_only=False)
    assert isinstance(saved, MultipleHeadJointEncoder)
    assert isinstance(torch.load(os.path.join(tmp_path, "encoders.pkl"),
                                 weights_only=False), dict)
    reloaded = JMVAE.load_from_folder(str(tmp_path), device="cpu")
    assert isinstance(reloaded.joint_encoder, MultipleHeadJointEncoder)
    assert reloaded.joint_encoder.dense[0].out_features == HID
    assert sorted(reloaded.model_config.custom_architectures) == sorted(
        tmodel.model_config.custom_architectures)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
    batch = batch_from_arrays(_arrays(seed=13))
    key = jax.random.key(2)
    outs = []
    for model in (tmodel, reloaded):
        model.draw_noise = _keyed_noise(key)
        with torch.no_grad():
            outs.append(model.loss_function(batch, StepInfo(epoch=2)).loss.item())
    assert outs[0] == outs[1]


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs(alpha=0.2, warmup=7)
    jcfg, tcfg = JJMVAEConfig(**kw), JMVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert JMVAEConfig().to_dict() == JJMVAEConfig().to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert JMVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "JMVAEConfig"
    assert JJMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


@pytest.mark.parametrize("warmup", [3, 1])
def test_trainer_curve_and_kept_weights_match_jax_trainer(tmp_path, warmup):
    """3 epochs of BaseTrainer (Adam 1e-3) on 20 rows in batches of 8 (the
    last one padded) with a 16-row eval set, against the JAX trainer: the
    same weights, batch order and noise. With warm-up 3 every epoch is in
    the keep-best window (``start_keep_best_epoch`` 4): the last epoch's
    weights are kept and the best eval loss stays inf; with warm-up 1 the
    window is epochs 1-2 and epoch 3 is kept only if its eval loss is the
    best since."""
    data, eval_data = _arrays(seed=5, n=20), _arrays(seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls="Adam")
    jmodel, tmodel = _models(warmup=warmup)
    assert tmodel.start_keep_best_epoch == jmodel.start_keep_best_epoch == warmup + 1
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JDataset(data), JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common),
                        callbacks=[rec])
    jtrainer.train()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data),
                          MultimodalBaseDataset(eval_data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, _keyed_noise, SEED)
    trainer.train()
    assert next(steps) == 3 * 3                 # 3 epochs x 3 steps
    for key in ("train_epoch_loss", "eval_epoch_loss", "train_elbo", "eval_beta"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 9 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    assert trainer.best_eval_loss == jtrainer.best_eval_loss or np.isclose(
        trainer.best_eval_loss, jtrainer.best_eval_loss, rtol=1e-4)
    assert np.isinf(trainer.best_eval_loss) == (warmup == 3)
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
    best = trainer.best_model
    assert best is tmodel
    for name, v in tmodel.state_dict().items():
        assert torch.equal(v, trainer._best_state[name]), name
