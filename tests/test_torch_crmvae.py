"""The port's CRMVAE against the JAX package's, on the CPU at a small size:
3 modalities on the MLP nets (hidden 16), latent 8, batch 8, on complete
batches and on incomplete ones with a row that has no modality, and one
case with an image modality on the resnet nets of the published run
(``nf=8, nf_max=16``, no private branch).

Weights cross with ``params_from_jax``; the Gaussian noise of the joint
code and of each modality's code is ``jax.random.normal`` of the JAX
code's keys, handed to the port through ``draw_noise``. Compared: the
loss, ``loss_sum``, every metric and every parameter gradient; a 3-epoch
``BaseTrainer`` curve with ``drop_last`` and an eval set; encode / predict
/ generate_from_prior; the joint NLL; the config JSON round-trip.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import CRMVAE as JCRMVAE
from multivae_tpu.models import CRMVAEConfig as JCRMVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import CRMVAE, CRMVAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP, mmnist
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import normal

torch.set_num_threads(2)

MLP_DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
IMAGE_DIMS = {"m0": (3, 28, 28), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "laplace", "m1": "bernoulli", "m2": "normal"}
LATENT, HID, B, SEED = 8, 16, 8, 11
M = 3
# Losses and metrics are sums of 10^2-10^4 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through the PoE and the nets (up to 7 convolutions): 1e-4
# relative, with an absolute floor of 1e-5 of the tensor's largest entry
# for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(dims=MLP_DIMS):
    return dict(n_modalities=M, latent_dim=LATENT, input_dims=dims,
                uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
                decoder_dist_params={"m0": {"scale": 0.75}}, beta=0.1)


def _nets(lib, image):
    if lib == "jax":
        Enc, Dec, Cfg, ns = JEncoder, JDecoder, JAEConfig, jmmnist
    else:
        Enc, Dec, Cfg, ns = Encoder_VAE_MLP, Decoder_AE_MLP, BaseAEConfig, mmnist
    dims = IMAGE_DIMS if image else MLP_DIMS
    cfg = {m: Cfg(input_dim=d, latent_dim=LATENT) for m, d in dims.items()}
    enc = {m: Enc(c, hidden_dim=HID) for m, c in cfg.items()}
    dec = {m: Dec(c, hidden_dim=HID) for m, c in cfg.items()}
    if image:
        enc["m0"] = ns.EncoderResnetMMNIST(private_latent_dim=0, shared_latent_dim=LATENT,
                                           nf=8, nf_max=16)
        dec["m0"] = ns.DecoderResnetMMNIST(latent_dim=LATENT, nf=8, nf_max=16)
    return enc, dec


def _models(image=False):
    kw = _config_kwargs(IMAGE_DIMS if image else MLP_DIMS)
    enc, dec = _nets("jax", image)
    jmodel = JCRMVAE(JCRMVAEConfig(**kw), encoders=enc, decoders=dec, seed=0)
    enc, dec = _nets("torch", image)
    tmodel = CRMVAE(CRMVAEConfig(**kw), encoders=enc, decoders=dec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, tmodel


def _arrays(incomplete, seed=0, n=B, dims=MLP_DIMS):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in dims.items()}
    if not incomplete:
        return data, None, None
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in dims}
    for m in dims:
        masks[m][0] = 1.0        # a complete row
        masks[m][1] = 0.0        # a row with no modality
    masks["m0"][2], masks["m1"][2], masks["m2"][2] = 0.0, 1.0, 0.0
    for m in dims:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0            # a loader padding row
    return data, masks, weights


def _normal(key, shape):
    return normal(key, shape)


def _loss_noise(rng):
    """The ``draw_noise`` hook of one ``loss_function(rng)`` call: the joint
    code's and each modality's noise, ``normal`` of ``split(rng, M + 1)``."""
    keys = jax.random.split(rng, M + 1)

    def noise(shape, generator=None):
        assert shape[0] == M + 1
        return torch.stack([_normal(k, shape[1:]) for k in keys])

    return noise


@pytest.mark.parametrize("case", ["complete", "incomplete", "resnet_incomplete"])
def test_loss_metrics_and_every_gradient_match_jax(case):
    image = case.startswith("resnet")
    jmodel, tmodel = _models(image)
    data, masks, weights = _arrays(case.endswith("incomplete"),
                                   dims=IMAGE_DIMS if image else MLP_DIMS)
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    tmodel.draw_noise = _loss_noise(key)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    assert out.loss_sum is out.loss
    assert set(out.metrics) == set(ref.metrics)
    assert {"joint_divergence", "kl_m0", "recon_m0_from_joint", "recon_m0_from_m0"} <= set(
        out.metrics)
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        ref_g = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref_g, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * np.abs(ref_g).max())


class _Recorder(TrainingCallback):
    def __init__(self):
        self.logs = []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (the published run's Adam 5e-4 and
    ``drop_last``) on 20 incomplete rows in batches of 8 (2 a epoch), with a
    16-row eval set, against the JAX trainer: same weights and batch order,
    the port's draws patched to the JAX trainer's (train:
    ``fold_in(key(seed), step)``; eval: ``key(seed + 1000 + epoch)``)."""
    data, masks, _ = _arrays(True, seed=5, n=20)
    eval_data, _, _ = _arrays(False, seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=5e-4, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls="Adam",
                  drop_last=True)
    jmodel, tmodel = _models()
    rec = _Recorder()
    JTrainer(jmodel, JIncompleteDataset(data, masks), JDataset(eval_data),
             training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                            n_devices=1, **common),
             callbacks=[rec]).train()

    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks),
                          MultimodalBaseDataset(eval_data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = itertools.count()

    def noise(shape, generator=None):
        if generator is trainer.generator:
            key = jax.random.fold_in(jax.random.key(SEED), next(steps))
        else:
            key = jax.random.key(generator.initial_seed())
        return _loss_noise(key)(shape)

    tmodel.draw_noise = noise
    trainer.train()
    assert next(steps) == 3 * 2                 # 3 epochs x 2 steps
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 6 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)


def test_encode_predict_generate_match_jax():
    jmodel, tmodel = _models()
    data, masks, _ = _arrays(True, seed=6)
    complete, _, _ = _arrays(False, seed=6)
    key = jax.random.key(7)
    tmodel.draw_noise = lambda shape, generator=None: _normal(key, shape)
    with torch.no_grad():
        for cond, N, flatten, mean, shape in (
                (["m0", "m2"], 3, True, False, (3 * B, LATENT)),
                (["m1"], 3, False, False, (3, B, LATENT)),
                ("all", 1, False, False, (B, LATENT)),
                (["m2", "m0"], 2, False, True, (2, B, LATENT))):
            ref = jmodel.encode(complete, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            out = tmodel.encode(complete, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
        # rows missing conditioning modalities: the masked PoE of what they hold
        ref = jmodel.encode(JIncompleteDataset(data, masks), cond_mod=["m0", "m1"],
                            rng=key, ignore_incomplete=True)
        out = tmodel.encode(IncompleteDataset(data, masks), cond_mod=["m0", "m1"],
                            ignore_incomplete=True)
        np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)

        ref = jmodel.predict(complete, cond_mod=["m0"], gen_mod="all", N=3, rng=key)
        out = tmodel.predict(complete, cond_mod=["m0"], gen_mod="all", N=3)
        for m, d in MLP_DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)
        ref = jmodel.generate_from_prior(5, rng=key)
        out = tmodel.generate_from_prior(5)
        np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
        rec, jrec = tmodel.decode(out, "m2"), jmodel.decode(ref, "m2")
        np.testing.assert_allclose(rec["m2"].numpy(), np.asarray(jrec["m2"]),
                                   **VALUE_TOL)


def test_joint_nll_matches_jax():
    jmodel, tmodel = _models()
    data, _, _ = _arrays(False, seed=8)
    key = jax.random.key(9)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    subs, chain = [], key
    for _ in range(3):
        chain, sub = jax.random.split(chain)
        subs.append(sub)
    keys, shapes = iter(subs), []

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return _normal(next(keys), shape)

    tmodel.draw_noise = noise
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert shapes == [(3, B, LATENT), (3, B, LATENT), (1, B, LATENT)]
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        tmodel.compute_joint_nll(IncompleteDataset(*_arrays(True)[:2]), K=K)


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs()
    jcfg, tcfg = JCRMVAEConfig(**kw), CRMVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert CRMVAEConfig().to_dict() == JCRMVAEConfig().to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert CRMVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "CRMVAEConfig"
    assert JCRMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_save_and_reload_with_resnet_nets(tmp_path):
    _, tmodel = _models(image=True)
    tmodel.save(str(tmp_path))
    reloaded = CRMVAE.load_from_folder(str(tmp_path), device="cpu")
    assert isinstance(reloaded.encoders["m0"], mmnist.EncoderResnetMMNIST)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
