"""The port's MMVAE+ against the JAX package's, on the CPU at a small size:
3 modalities (a 3x28x28 image on the resnet nets at ``nf=8, nf_max=16``,
two vectors on the multi-latent MLP nets), latent 8, private 4, K=1 and
K=3, batch 8, on incomplete masks.

Weights cross with ``params_from_jax``; every draw is made with
``jax.random`` as the JAX code makes it (the u and w noise per modality,
then one prior draw per recon modality, the expert of ``encode``) and
handed to the port through ``draw_noise`` and ``draw_expert``. Compared:
the loss and every parameter gradient of both objectives, ``use_remat``,
a 3-epoch ``BaseTrainer`` curve with AMSGrad, encode (both
``reconstruction_option``s) / predict / generate_from_prior + decode, and
the joint NLL.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MMVAEPlus as JMMVAEPlus
from multivae_tpu.models import MMVAEPlusConfig as JMMVAEPlusConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import IncompleteDataset, batch_from_arrays
from multivae_tpu_torch.models import MMVAEPlus, MMVAEPlusConfig
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import LAPLACE_LOW, uniform

torch.set_num_threads(2)

DIMS = {"m0": (3, 28, 28), "m1": (5,), "m2": (6,)}
LATENT, STYLE, HID, NF, NF_MAX, B, SEED = 8, 4, 16, 8, 16, 8, 11
M = len(DIMS)
# Losses are sums of 10^3-10^4 float32 terms taken in another order by XLA
# and by PyTorch: 1e-5 relative. Gradients add the DReG/IWAE weights
# exp(lw - logsumexp lw), whose relative error is the absolute error of lw
# (~1e-4 at |lw| ~ 10^3), through up to 9 convolutions: 1e-4 relative, with
# an absolute floor of 1e-5 of the tensor's largest entry for entries that
# cancel to ~0 (a conv kernel's gradient sums ~10^4 terms of both signs).
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(K=3, loss="dreg_looser", option="joint_prior", **extra):
    return dict(n_modalities=M, latent_dim=LATENT, modalities_specific_dim=STYLE,
                input_dims=DIMS, K=K, loss=loss, beta=2.5,
                prior_and_posterior_dist="laplace_with_softmax",
                learn_modality_prior=True, learn_shared_prior=True,
                reconstruction_option=option, uses_likelihood_rescaling=True,
                decoders_dist={"m0": "laplace", "m1": "laplace", "m2": "normal"},
                decoder_dist_params={m: {"scale": 0.75} for m in ("m0", "m1")},
                **extra)


def _nets(lib):
    if lib == "jax":
        ns, ml, Cfg = jmmnist, jdefault, JAEConfig
    else:
        ns, ml, Cfg = mmnist, default, BaseAEConfig
    enc = {"m0": ns.EncoderResnetMMNIST(private_latent_dim=STYLE, shared_latent_dim=LATENT,
                                        nf=NF, nf_max=NF_MAX)}
    dec = {"m0": ns.DecoderResnetMMNIST(latent_dim=LATENT + STYLE, nf=NF, nf_max=NF_MAX)}
    for m in ("m1", "m2"):
        enc[m] = ml.Encoder_VAE_MLP_Style(
            Cfg(input_dim=DIMS[m], latent_dim=LATENT, style_dim=STYLE), hidden_dim=HID)
        dec[m] = ml.Decoder_AE_MLP(Cfg(input_dim=DIMS[m], latent_dim=LATENT + STYLE),
                                   hidden_dim=HID)
    return enc, dec


def _models(**kw):
    enc, dec = _nets("jax")
    jmodel = JMMVAEPlus(JMMVAEPlusConfig(**_config_kwargs(**kw)), encoders=enc,
                        decoders=dec, seed=0)
    # non-trivial priors, so their gradient paths are exercised
    rng = np.random.default_rng(1)
    for name, value in jmodel.params["model"].items():
        jmodel.params["model"][name] = jnp.asarray(
            rng.normal(size=value.shape).astype(np.float32) * 0.3)
    return jmodel, _port_model(jmodel, **kw)


def _port_model(jmodel, **kw):
    enc, dec = _nets("torch")
    tmodel = MMVAEPlus(MMVAEPlusConfig(**_config_kwargs(**kw)), encoders=enc,
                       decoders=dec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return tmodel


@pytest.fixture(scope="module")
def shared_models():
    """``_models(**kw)`` with its JAX model made once per configuration for
    the tests that only read it, which then share its compiles (a fresh
    port model each time)."""
    jax_models = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in jax_models:
            jax_models[key] = _models(**kw)[0]
        return jax_models[key], _port_model(jax_models[key], **kw)

    return get


def _arrays(seed=0, n=B, incomplete=True):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}
    if not incomplete:
        return data, None, None
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in DIMS}
    for m in DIMS:
        masks[m][0] = 1.0              # a complete row
    masks["m0"][1], masks["m1"][1], masks["m2"][1] = 1.0, 0.0, 0.0   # one modality
    for m in DIMS:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0                  # a loader padding row
    return data, masks, weights


class _JaxDraws:
    """``draw_noise`` / ``draw_expert`` hooks returning the JAX package's
    draws: the Laplace noise ``uniform(key, shape, -0.5 + eps, 0.5)`` of
    each key in ``keys`` in turn, and the expert index ``expert(n)``."""

    def __init__(self, keys, expert=None):
        self.keys, self.expert_fn, self.shapes = list(keys), expert, []

    def noise(self, shape, generator=None):
        self.shapes.append(tuple(shape))
        return uniform(self.keys.pop(0), shape, LAPLACE_LOW, 0.5)

    def expert(self, n, generator=None):
        return self.expert_fn(n)

    def install(self, model):
        model.draw_noise, model.draw_expert = self.noise, self.expert
        return self


def _loss_keys(rng):
    """The keys of one ``loss_function`` call: u and w of each modality,
    then one prior draw per recon modality."""
    _, s_rng, r_rng = jax.random.split(rng, 3)
    return list(jax.random.split(s_rng, 2 * M)) + list(jax.random.split(r_rng, M))


def _chain(key, n):
    """The keys ``lax.scan`` hands out: the carry split once per chunk."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _jax_loss_and_grads(jmodel, arrays, key):
    data, masks, weights = arrays
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def loss(params):
        return jmodel.loss_function(params, batch, key, step).loss

    value, grads = jax.jit(jax.value_and_grad(loss))(jmodel.params)
    return float(value), params_from_jax(jax.tree.map(np.asarray, grads))


def _port_loss(tmodel, arrays, key):
    data, masks, weights = arrays
    draws = _JaxDraws(_loss_keys(key)).install(tmodel)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks,
                                                 weights=weights))
    assert not draws.keys
    return out.loss, draws


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("loss", ["dreg_looser", "iwae_looser"])
def test_loss_and_every_gradient_match_jax(shared_models, loss, K):
    jmodel, tmodel = shared_models(K=K, loss=loss)
    arrays, key = _arrays(), jax.random.key(2)
    ref_loss, ref_grads = _jax_loss_and_grads(jmodel, arrays, key)
    value, draws = _port_loss(tmodel, arrays, key)
    value.backward()
    assert draws.shapes[:2] == [(K, B, LATENT), (K, B, STYLE)]
    assert draws.shapes[2 * M:] == [(K, M, B, STYLE)] * M
    np.testing.assert_allclose(value.item(), ref_loss, **LOSS_TOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    assert {"prior_log_var_m0", "prior_log_var_shared"} <= set(grads)
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * np.abs(ref).max())


def test_use_remat_gives_the_same_gradients(shared_models):
    """Rematerialization recomputes each decoder's forward in the backward
    (its first layer runs twice) and changes no number (1e-7 relative: the
    recomputation repeats the same kernels)."""
    _, tmodel = shared_models(K=3, loss="iwae_looser")
    arrays, key = _arrays(seed=3), jax.random.key(4)
    calls = []
    tmodel.decoders["m0"].dense[0].register_forward_hook(lambda *_: calls.append(1))
    results = []
    for remat in (False, True):
        tmodel.model_config.use_remat = remat
        tmodel.zero_grad()
        calls.clear()
        value, _ = _port_loss(tmodel, arrays, key)
        value.backward()
        results.append((value.item(), {n: p.grad.clone()
                                       for n, p in tmodel.named_parameters()},
                        len(calls)))
    (v0, g0, c0), (v1, g1, c1) = results
    assert (c0, c1) == (1, 2)
    assert v0 == v1
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=1e-7,
                                   atol=1e-12, err_msg=name)


class _Recorder(TrainingCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, training_config, logs, **kwargs):
        self.losses.append(logs["train_epoch_loss"])


def test_trainer_curve_with_amsgrad_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam with amsgrad, lr 1e-3, IWAE, K=3) on 20
    incomplete rows in batches of 8 (the last one padded) vs the JAX
    trainer: same weights, same batch order, the port's draws patched to
    the JAX trainer's (``fold_in(key(seed), step)`` into ``loss_function``)."""
    data, masks, _ = _arrays(seed=5, n=20)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  seed=SEED, optimizer_cls="Adam", optimizer_params={"amsgrad": True})
    jmodel, tmodel = _models(K=3, loss="iwae_looser")
    rec = _Recorder()
    JTrainer(jmodel, JIncompleteDataset(data, masks), training_config=JTrainerConfig(
        output_dir=str(tmp_path / "jax"), n_devices=1, **common), callbacks=[rec]).train()

    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    calls = itertools.count()

    def jax_trainer_noise(shape, generator=None):
        step, i = divmod(next(calls), 3 * M)
        key = _loss_keys(jax.random.fold_in(jax.random.key(SEED), step))[i]
        return uniform(key, shape, LAPLACE_LOW, 0.5)

    tmodel.draw_noise = jax_trainer_noise
    trainer.train()
    assert next(calls) == 3 * 3 * 3 * M       # 3 epochs x 3 steps x 3M draws
    ours = [h["train_epoch_loss"] for h in trainer.history]
    # float32 drift over 9 AMSGrad steps of two implementations
    np.testing.assert_allclose(ours, rec.losses, rtol=1e-4)


def _subset_expert(cond, subset_key):
    """The JAX package's encode draws the expert over the subset indicator
    (``categorical(key, log(subset))``, an index among all modalities)."""
    subset = jnp.asarray([1.0 if m in cond else 0.0 for m in DIMS])
    idx = int(jax.random.categorical(subset_key, jnp.log(subset)))
    return lambda n: cond.index(list(DIMS)[idx])


@pytest.mark.parametrize("option", ["joint_prior", "single_prior"])
def test_encode_predict_generate_match_jax(shared_models, option):
    jmodel, tmodel = shared_models(option=option)
    data, _, _ = _arrays(seed=6, incomplete=False)
    key = jax.random.key(7)
    rest, choice, sample = jax.random.split(key, 3)
    style_keys = list(jax.random.split(rest, M))
    cond = ["m0", "m2"]
    with torch.no_grad():
        for N, flatten, mean in ((3, True, False), (3, False, False), (1, False, False),
                                 (2, False, True)):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            draws = _JaxDraws([] if mean else [sample] + style_keys,
                              _subset_expert(cond, choice)).install(tmodel)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert not draws.keys and not out.one_latent_space
            assert out.z.shape == ref.z.shape
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            assert set(out.modalities_z) == set(DIMS)
            for m in DIMS:
                assert out.modalities_z[m].shape == ref["modalities_z"][m].shape
                np.testing.assert_allclose(out.modalities_z[m].numpy(),
                                           np.asarray(ref["modalities_z"][m]),
                                           err_msg=m, **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=cond, gen_mod="all", N=3, rng=key)
        _JaxDraws([sample] + style_keys, _subset_expert(cond, choice)).install(tmodel)
        out = tmodel.predict(data, cond_mod=cond, gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)

        for n_samples, shape in ((5, (5, LATENT + STYLE)), (1, (LATENT + STYLE,))):
            ref = jmodel.generate_from_prior(n_samples, rng=key)
            _JaxDraws([key]).install(tmodel)
            out = tmodel.generate_from_prior(n_samples)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            rec, jrec = tmodel.decode(out), jmodel.decode(ref)
            for m, d in DIMS.items():
                assert rec[m].shape == (*shape[:-1], *d)
                np.testing.assert_allclose(rec[m].numpy(), np.asarray(jrec[m]),
                                           err_msg=m, **VALUE_TOL)


def test_joint_nll_matches_jax(shared_models):
    jmodel, tmodel = shared_models()
    data, _, _ = _arrays(seed=8, incomplete=False)
    key = jax.random.key(9)
    K, chunk = 9, 2            # 3 samples per expert: chunks of 2 and 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys = [k for sub in _chain(key, 2) for k in _loss_keys_of_chunk(sub)]
    draws = _JaxDraws(keys).install(tmodel)
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert not draws.keys and draws.shapes[2 * M] == (2, M, B, STYLE)
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        tmodel.compute_joint_nll(IncompleteDataset(*_arrays(seed=8)[:2]), K=K)


def _loss_keys_of_chunk(sub):
    s_rng, r_rng = jax.random.split(sub)
    return list(jax.random.split(s_rng, 2 * M)) + list(jax.random.split(r_rng, M))


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs(K=1, option="single_prior")
    jcfg, tcfg = JMMVAEPlusConfig(**kw), MMVAEPlusConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert MMVAEPlusConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "MMVAEPlusConfig"
    assert JMMVAEPlusConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg
    with pytest.raises(ValueError):
        MMVAEPlusConfig(**{**kw, "reconstruction_option": "no_prior"})
    with pytest.raises(AttributeError, match="modalities_specific_dim"):
        MMVAEPlus(MMVAEPlusConfig(**{**kw, "modalities_specific_dim": None}), device="cpu")


def test_default_nets_save_and_reload(tmp_path):
    dims = {"a": (5,), "b": (1, 2, 3)}
    cfg = dict(n_modalities=2, latent_dim=LATENT, modalities_specific_dim=STYLE,
               input_dims=dims, K=2)
    model = MMVAEPlus(MMVAEPlusConfig(**cfg), seed=3, device="cpu")
    assert isinstance(model.encoders["a"], default.Encoder_VAE_MLP_Style)
    assert model.decoders["b"].latent_dim == LATENT + STYLE
    data = {m: np.random.default_rng(0).uniform(size=(4, *d)).astype(np.float32)
            for m, d in dims.items()}
    out = model(data, generator=torch.Generator().manual_seed(0))
    assert out.loss.shape == () and torch.isfinite(out.loss)
    model.save(str(tmp_path))
    reloaded = MMVAEPlus.load_from_folder(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
