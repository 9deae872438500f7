"""The port's DMVAE against the JAX package's, on the CPU at a small size:
3 modalities on the multi-latent MLP nets (hidden 16), shared latent 6,
private dims {1, 2, 3}, batch 8, on complete batches and on masked ones
with a row that has no modality and a padding row.

Weights cross with ``params_from_jax``; noise is the JAX package's
``jax.random.normal`` of each draw's key. The loss's M+1 ELBOs each split
their key into a shared draw and one private draw per modality; the port
draws the shared noise of all M+1 ELBOs, then each modality's private
noise of all M+1, and the test stacks the JAX draws in that order.
Compared: the loss, ``loss_sum``, every metric and every gradient; encode
(private codes from the posterior or the prior), predict and
generate_from_prior; the K-sample joint NLL; the config JSON round trip;
and a 3-epoch ``BaseTrainer`` curve with an eval set against the JAX
trainer, with the kept weights.
"""

import json

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import DMVAE as JDMVAE
from multivae_tpu.models import DMVAEConfig as JDMVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP_Style as JEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import DMVAE, DMVAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import (
    BaseAEConfig,
    BaseDictDecodersMultiLatents,
    BaseDictEncoders_MultiLatents,
    Decoder_AE_MLP,
    Encoder_VAE_MLP_Style,
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
STYLE = {"m0": 1, "m1": 2, "m2": 3}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED = 6, 16, 8, 11
M = len(DIMS)
# Losses and metrics are sums of 10^2-10^3 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through the PoE and 2 layers: 1e-4 relative, with an absolute
# floor of 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
              modalities_specific_dim=dict(STYLE),
              modalities_specific_betas={"m0": 1.0, "m1": 0.5, "m2": 2.0}, beta=1.5,
              uses_likelihood_rescaling=True, rescale_factors={"m0": 50.0, "m1": 1.0,
                                                               "m2": 3.0},
              decoders_dist=dict(DISTS), decoder_dist_params={"m2": {"scale": 0.75}})
    kw.update(extra)
    return kw


def _models(**extra):
    jmodel = JDMVAE(JDMVAEConfig(**_config_kwargs(**extra)),
                    encoders={m: JEncoder(JAEConfig(input_dim=d, latent_dim=LATENT,
                                                    style_dim=STYLE[m]), hidden_dim=HID)
                              for m, d in DIMS.items()},
                    decoders={m: JDecoder(JAEConfig(input_dim=d,
                                                    latent_dim=LATENT + STYLE[m]),
                                          hidden_dim=HID) for m, d in DIMS.items()},
                    seed=0)
    tmodel = DMVAE(DMVAEConfig(**_config_kwargs(**extra)),
                   encoders={m: Encoder_VAE_MLP_Style(
                       BaseAEConfig(input_dim=d, latent_dim=LATENT, style_dim=STYLE[m]),
                       hidden_dim=HID) for m, d in DIMS.items()},
                   decoders={m: Decoder_AE_MLP(
                       BaseAEConfig(input_dim=d, latent_dim=LATENT + STYLE[m]),
                       hidden_dim=HID) for m, d in DIMS.items()},
                   device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _arrays(incomplete, seed=0, n=B):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}
    if not incomplete:
        return data, None, None
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in DIMS}
    for m in DIMS:
        masks[m][0] = 1.0        # a complete row
        masks[m][1] = 0.0        # a row with no modality
    masks["m0"][2], masks["m1"][2], masks["m2"][2] = 0.0, 1.0, 0.0
    for m in DIMS:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0            # a loader padding row
    return data, masks, weights


def _loss_noise(key):
    """The ``draw_noise`` hook of one loss call: the JAX draws of ELBO i
    come from ``split(split(key, M + 1)[i], M + 1)``, the shared one first."""
    subs = [jax.random.split(k, M + 1) for k in jax.random.split(key, M + 1)]
    draws = iter(range(M + 1))      # the shared draw, then each modality's

    def noise(shape, generator=None):
        j = next(draws)
        assert shape[0] == M + 1, shape
        return torch.stack([normal(s[j], shape[1:]) for s in subs])
    return noise


def _split_noise(key, n):
    """Draws from ``split(key, n)`` in order (generate_from_prior)."""
    keys = iter(jax.random.split(key, n))
    return lambda shape, generator=None: normal(next(keys), shape)


def _encode_noise(key):
    """encode: ``rng, z_rng = split(key)``; z from ``z_rng``, the private codes
    from ``split(rng, M)``."""
    rng, z_rng = jax.random.split(key)
    keys = iter([z_rng, *jax.random.split(rng, M)])
    return lambda shape, generator=None: normal(next(keys), shape)


@pytest.mark.parametrize("incomplete", [False, True], ids=["complete", "masked"])
def test_loss_metrics_and_every_gradient_match_jax(incomplete):
    jmodel, tmodel = _models()
    assert tmodel.style_dims == jmodel.style_dims == STYLE
    assert tmodel.rescale_factors == jmodel.rescale_factors
    data, masks, weights = _arrays(incomplete)
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    shapes, draw = [], _loss_noise(key)

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return draw(shape)

    tmodel.draw_noise = noise
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights),
                               StepInfo(epoch=1, dataset_size=B))
    out.loss.backward()
    assert shapes == [(M + 1, B, LATENT)] + [(M + 1, B, STYLE[m]) for m in DIMS]
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"joint", *DIMS}
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert g is not None and np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_encode_predict_generate_match_jax():
    jmodel, tmodel = _models()
    data, _, _ = _arrays(False, seed=6)
    key = jax.random.key(7)
    with torch.no_grad():
        for cond, N, flatten, mean in ((["m0", "m2"], 3, True, False),
                                       ("m1", 3, False, False),
                                       ("all", 1, False, False),
                                       (["m2", "m0"], 2, False, True)):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            tmodel.draw_noise = _encode_noise(key)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == ref.z.shape and not out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            for m in DIMS:
                assert out.modalities_z[m].shape[-1] == STYLE[m]
                np.testing.assert_allclose(out.modalities_z[m].numpy(),
                                           np.asarray(ref.modalities_z[m]), err_msg=m,
                                           **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=["m1"], gen_mod="all", N=3, rng=key)
        tmodel.draw_noise = _encode_noise(key)
        out = tmodel.predict(data, cond_mod=["m1"], gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)
        for n in (5, 1):
            ref = jmodel.generate_from_prior(n, rng=key)
            tmodel.draw_noise = _split_noise(key, M + 1)
            out = tmodel.generate_from_prior(n)
            assert out.z.shape == ((n, LATENT) if n > 1 else (LATENT,))
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            for m in DIMS:
                np.testing.assert_allclose(out.modalities_z[m].numpy(),
                                           np.asarray(ref.modalities_z[m]), **VALUE_TOL)
        ref = jmodel.generate_from_prior(5, rng=key)
        tmodel.draw_noise = _split_noise(key, M + 1)
        rec, jrec = tmodel.decode(tmodel.generate_from_prior(5)), jmodel.decode(ref)
        for m in DIMS:
            np.testing.assert_allclose(rec[m].numpy(), np.asarray(jrec[m]), **VALUE_TOL)


def test_encode_ignoring_incomplete_rows_matches_jax():
    jmodel, tmodel = _models()
    data, masks, _ = _arrays(True, seed=8)
    key = jax.random.key(9)
    ref = jmodel.encode(JIncompleteDataset(data, masks), cond_mod=["m0", "m1"], rng=key,
                        ignore_incomplete=True)
    tmodel.draw_noise = _encode_noise(key)
    with torch.no_grad():
        out = tmodel.encode(IncompleteDataset(data, masks), cond_mod=["m0", "m1"],
                            ignore_incomplete=True)
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
    with pytest.raises(AttributeError, match="incomplete dataset"):
        tmodel.encode(IncompleteDataset(data, masks), cond_mod="m1")


def test_joint_nll_matches_jax():
    jmodel, tmodel = _models()
    data, _, _ = _arrays(False, seed=10)
    key = jax.random.key(11)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys, shapes = [], []
    for c in chain(key, 3):
        rng, z_rng = jax.random.split(c)
        keys += [z_rng, *jax.random.split(rng, M)]
    keys = iter(keys)

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return normal(next(keys), shape)

    tmodel.draw_noise = noise
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert shapes == [s for n in (3, 3, 1) for s in
                      [(n, B, LATENT)] + [(n, B, STYLE[m]) for m in DIMS]]
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        tmodel.compute_joint_nll(IncompleteDataset(*_arrays(True)[:2]), K=K)


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs()
    jcfg, tcfg = JDMVAEConfig(**kw), DMVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert DMVAEConfig().to_dict() == JDMVAEConfig().to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert DMVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "DMVAEConfig"
    assert JDMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_default_nets_train_and_reload(tmp_path):
    """The default multi-latent nets take the private dims, and a trained
    model reloads with the same weights; mismatched keys are refused."""
    model = DMVAE(DMVAEConfig(n_modalities=2, latent_dim=4, input_dims={"a": (5,),
                                                                       "b": (1, 2, 3)},
                              modalities_specific_dim={"a": 2, "b": 3}),
                  seed=3, device="cpu")
    assert model.decoders["b"].latent_dim == 7
    data = {m: np.random.default_rng(0).uniform(size=(4, *d)).astype(np.float32)
            for m, d in {"a": (5,), "b": (1, 2, 3)}.items()}
    out = model(data, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out.loss)
    model.save(str(tmp_path))
    reloaded = DMVAE.load_from_folder(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
    dims = {"a": (5,), "b": (3,)}
    nets = dict(encoders=BaseDictEncoders_MultiLatents(dims, 4, {"a": 2, "b": 1}),
                decoders=BaseDictDecodersMultiLatents(dims, 4, {"a": 2, "b": 1}))
    with pytest.raises(AttributeError, match="modalities_specific_dim"):
        DMVAE(DMVAEConfig(n_modalities=2, latent_dim=4, input_dims=dims,
                          modalities_specific_dim={"a": 2}), **nets, device="cpu")


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3) on 20 incomplete rows in batches
    of 8 (the last one padded) with a 16-row eval set, against the JAX
    trainer: the same weights, batch order and noise; the epoch losses and
    metrics, the best eval loss and the kept weights."""
    data, masks, _ = _arrays(True, seed=5, n=20)
    eval_data, _, _ = _arrays(False, seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls="Adam")
    jmodel, tmodel = _models()
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JIncompleteDataset(data, masks), JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common),
                        callbacks=[rec])
    jtrainer.train()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks),
                          MultimodalBaseDataset(eval_data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, _loss_noise, SEED)
    trainer.train()
    assert next(steps) == 3 * 3
    for key in ("train_epoch_loss", "eval_epoch_loss", "train_joint", "eval_m2"):
        np.testing.assert_allclose([h[key] for h in trainer.history],
                                   [h[key] for h in rec.logs], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(trainer.best_eval_loss, jtrainer.best_eval_loss, rtol=1e-4)
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
