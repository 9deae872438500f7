"""The port's CMVAE against the JAX package's, on the CPU at a small size:
3 vector modalities on the multi-latent MLP nets (hidden 16), latent 8,
private 4, 5 clusters, K=1 and K=3, batch 8, on incomplete masks with a
row that has no modality. (The resnet nets of the published run are held
to Flax by ``tests/test_torch_resnet_nets.py``.)

Weights cross with ``params_from_jax`` (the cluster means and logits
through its ``model/<name>`` rule); every draw is made with ``jax.random``
as the JAX code makes it and handed to the port through ``draw_noise``,
``draw_expert`` and ``draw_clusters``. Compared: the loss and every
parameter gradient of both objectives, a 3-epoch ``BaseTrainer`` curve with
AMSGrad, encode on several subsets (both ``reconstruction_option``s) /
predict / generate_from_prior + decode, the joint NLL, ``predict_clusters``,
``prune_clusters``, and the non-finite loss and NLL of a pruned model,
which the port shares with the JAX package.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import CMVAE as JCMVAE
from multivae_tpu.models import CMVAEConfig as JCMVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import CMVAE, CMVAEConfig
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import LAPLACE_LOW, uniform

torch.set_num_threads(2)

DIMS = {"m0": (7,), "m1": (5,), "m2": (6,)}
LATENT, STYLE, HID, C, B, SEED = 8, 4, 16, 5, 8, 11
M = len(DIMS)
# Losses are sums of 10^2-10^3 float32 terms taken in another order by XLA
# and by PyTorch: 1e-5 relative. Gradients add the IWAE/DReG weights and
# q(c|z), softmaxes whose relative error is the absolute error of their
# logits: 1e-4 relative, with an absolute floor of 1e-5 of the tensor's
# largest entry for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
# Latent samples, decoder outputs and cluster posteriors: elementwise, a few
# ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(K=3, loss="dreg_looser", option="joint_prior", **extra):
    return dict(n_modalities=M, latent_dim=LATENT, modalities_specific_dim=STYLE,
                input_dims=DIMS, K=K, loss=loss, beta=2.5, number_of_clusters=C,
                prior_and_posterior_dist="laplace_with_softmax",
                learn_modality_prior=True, reconstruction_option=option,
                uses_likelihood_rescaling=True,
                decoders_dist={"m0": "laplace", "m1": "laplace", "m2": "normal"},
                decoder_dist_params={m: {"scale": 0.75} for m in ("m0", "m1")},
                **extra)


def _nets(lib):
    ml, Cfg = (jdefault, JAEConfig) if lib == "jax" else (default, BaseAEConfig)
    enc = {m: ml.Encoder_VAE_MLP_Style(Cfg(input_dim=d, latent_dim=LATENT,
                                           style_dim=STYLE), hidden_dim=HID)
           for m, d in DIMS.items()}
    dec = {m: ml.Decoder_AE_MLP(Cfg(input_dim=d, latent_dim=LATENT + STYLE),
                                hidden_dim=HID) for m, d in DIMS.items()}
    return enc, dec


def _models(pruned=(), **kw):
    enc, dec = _nets("jax")
    jmodel = JCMVAE(JCMVAEConfig(**_config_kwargs(**kw)), encoders=enc, decoders=dec,
                    seed=0)
    # non-trivial priors and cluster weights, so their gradients are exercised
    rng = np.random.default_rng(1)
    for name, value in jmodel.params["model"].items():
        jmodel.params["model"][name] = jnp.asarray(
            rng.normal(size=value.shape).astype(np.float32) * 0.5)
    pc = np.asarray(jmodel.params["model"]["pc_params"]).copy()
    pc[list(pruned)] = -np.inf
    jmodel.params["model"]["pc_params"] = jnp.asarray(pc)
    return jmodel, _port_model(jmodel, **kw)


def _port_model(jmodel, **kw):
    enc, dec = _nets("torch")
    tmodel = CMVAE(CMVAEConfig(**_config_kwargs(**kw)), encoders=enc, decoders=dec,
                   device="cpu")
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
        masks[m][2] = 0.0              # a row with no modality
    masks["m0"][1], masks["m1"][1], masks["m2"][1] = 1.0, 0.0, 0.0   # one modality
    for m in DIMS:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0                  # a loader padding row
    return data, masks, weights


def _laplace_noise(key, shape):
    return uniform(key, shape, LAPLACE_LOW, 0.5)


class _JaxDraws:
    """``draw_noise`` / ``draw_expert`` / ``draw_clusters`` hooks returning
    the JAX package's draws: the Laplace noise of each key in ``keys`` in
    turn, the expert index ``expert(n)``, the clusters ``clusters``."""

    def __init__(self, keys, expert=None, clusters=None):
        self.keys, self.expert_fn, self.clusters, self.shapes = (
            list(keys), expert, clusters, [])

    def noise(self, shape, generator=None):
        self.shapes.append(tuple(shape))
        return _laplace_noise(self.keys.pop(0), shape)

    def expert(self, n, generator=None):
        return self.expert_fn(n)

    def draw_clusters(self, logits, n, generator=None):
        assert len(self.clusters) == n
        return torch.tensor(self.clusters)

    def install(self, model):
        model.draw_noise, model.draw_expert = self.noise, self.expert
        model.draw_clusters = self.draw_clusters
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


def _jax_loss(jmodel, arrays, key, grads=True):
    data, masks, weights = arrays
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def loss(params):
        return jmodel.loss_function(params, batch, key, step).loss

    if not grads:
        return float(jax.jit(loss)(jmodel.params)), None
    value, g = jax.jit(jax.value_and_grad(loss))(jmodel.params)
    return float(value), params_from_jax(jax.tree.map(np.asarray, g))


def _port_loss(tmodel, arrays, key):
    data, masks, weights = arrays
    draws = _JaxDraws(_loss_keys(key)).install(tmodel)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks,
                                                 weights=weights))
    assert not draws.keys and out.loss_sum is out.loss and out.metrics == {}
    return out.loss


def test_cluster_parameters_cross_from_jax(shared_models):
    """``params_from_jax`` maps ``model/pc_params`` and
    ``model/mean_clusters`` to the port's parameters of the same names and
    shapes, and the JAX model's extra parameters are exactly the port's."""
    jmodel, tmodel = shared_models()
    state = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    assert state["pc_params"].shape == (C,)
    assert state["mean_clusters"].shape == (C, LATENT)
    own = {n for n, _ in tmodel.named_parameters() if "." not in n}
    assert own == set(jmodel.params["model"]) == {
        "pc_params", "mean_clusters", *(f"prior_log_var_{m}" for m in DIMS)}
    np.testing.assert_array_equal(tmodel.mean_clusters.detach().numpy(),
                                  np.asarray(jmodel.params["model"]["mean_clusters"]))
    fresh = CMVAE(CMVAEConfig(**_config_kwargs()), device="cpu")
    assert fresh.mean_clusters.abs().max() <= 1.0 and fresh.pc_params.eq(0).all()


# the published run is K=1 IWAE; K=3 takes the sample axis through DReG's
# second pass as well
@pytest.mark.parametrize("loss, K", [("dreg_looser", 1), ("dreg_looser", 3),
                                     ("iwae_looser", 1)])
def test_loss_and_every_gradient_match_jax(shared_models, loss, K):
    jmodel, tmodel = shared_models(K=K, loss=loss)
    arrays, key = _arrays(), jax.random.key(2)
    ref_loss, ref_grads = _jax_loss(jmodel, arrays, key)
    value = _port_loss(tmodel, arrays, key)
    value.backward()
    np.testing.assert_allclose(value.item(), ref_loss, **LOSS_TOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * np.abs(ref).max())
    assert np.abs(grads["pc_params"].numpy()).max() > 0
    assert np.abs(grads["mean_clusters"].numpy()).max() > 0


class _Recorder(TrainingCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, training_config, logs, **kwargs):
        self.losses.append(logs["train_epoch_loss"])


def test_trainer_curve_with_amsgrad_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (the published run's Adam with amsgrad,
    K=1, IWAE) on 20 incomplete rows in batches of 8 (the last one padded)
    vs the JAX trainer: same weights, same batch order, the port's draws
    patched to the JAX trainer's (``fold_in(key(seed), step)``)."""
    data, masks, _ = _arrays(seed=5, n=20)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
                  seed=SEED, optimizer_cls="Adam", optimizer_params={"amsgrad": True})
    jmodel, tmodel = _models(K=1, loss="iwae_looser")
    rec = _Recorder()
    JTrainer(jmodel, JIncompleteDataset(data, masks), training_config=JTrainerConfig(
        output_dir=str(tmp_path / "jax"), n_devices=1, **common), callbacks=[rec]).train()

    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    calls = itertools.count()

    def jax_trainer_noise(shape, generator=None):
        step, i = divmod(next(calls), 3 * M)
        return _laplace_noise(
            _loss_keys(jax.random.fold_in(jax.random.key(SEED), step))[i], shape)

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


def _assert_close_codes(out, ref):
    assert out.z.shape == ref.z.shape and not out.one_latent_space
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
    assert set(out.modalities_z) == set(DIMS)
    for m in DIMS:
        assert out.modalities_z[m].shape == ref["modalities_z"][m].shape
        np.testing.assert_allclose(out.modalities_z[m].numpy(),
                                   np.asarray(ref["modalities_z"][m]), err_msg=m,
                                   **VALUE_TOL)


@pytest.mark.parametrize("option", ["joint_prior", "single_prior"])
def test_encode_predict_generate_match_jax(shared_models, option):
    jmodel, tmodel = shared_models(option=option)
    data, _, _ = _arrays(seed=6, incomplete=False)
    key = jax.random.key(7)
    rest, choice, sample = jax.random.split(key, 3)
    style_keys = list(jax.random.split(rest, M))
    # the options differ only in the prior of the modalities outside the subset
    cases = ((["m0", "m2"], 3, True, False), (["m2", "m1"], 2, False, True),
             (["m1"], 1, False, False))
    with torch.no_grad():
        for cond, N, flatten, mean in cases[:2] if option == "joint_prior" else cases[2:]:
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            draws = _JaxDraws([] if mean else [sample] + style_keys,
                              _subset_expert(cond, choice)).install(tmodel)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert not draws.keys
            _assert_close_codes(out, ref)

        cond = ["m0", "m2"]
        ref = jmodel.predict(data, cond_mod=cond, gen_mod="all", N=3, rng=key)
        _JaxDraws([sample] + style_keys, _subset_expert(cond, choice)).install(tmodel)
        out = tmodel.predict(data, cond_mod=cond, gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)

        # a batch of 6 under one option, one sample (shape (1, D)) under the other
        for n_samples in (6,) if option == "joint_prior" else (1,):
            ref = jmodel.generate_from_prior(n_samples, rng=key)
            rest, c_key, z_key = jax.random.split(key, 3)
            clusters = np.asarray(jax.random.categorical(
                c_key, jmodel.params["model"]["pc_params"], shape=(n_samples,)))
            _JaxDraws([z_key] + list(jax.random.split(rest, M)),
                      clusters=clusters).install(tmodel)
            out = tmodel.generate_from_prior(n_samples)
            assert out.z.shape == (n_samples, LATENT)
            _assert_close_codes(out, ref)
            if n_samples == 1:
                continue
            rec, jrec = tmodel.decode(out), jmodel.decode(ref)
            for m, d in DIMS.items():
                assert rec[m].shape == (n_samples, *d)
                np.testing.assert_allclose(rec[m].numpy(), np.asarray(jrec[m]),
                                           err_msg=m, **VALUE_TOL)


def test_joint_nll_matches_jax(shared_models):
    jmodel, tmodel = shared_models()
    data, _, _ = _arrays(seed=8, incomplete=False)
    key = jax.random.key(9)
    K, chunk = 9, 2            # 3 samples per expert: chunks of 2 and 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys = []
    for sub in _chain(key, 2):
        s_rng, r_rng = jax.random.split(sub)
        keys += list(jax.random.split(s_rng, 2 * M)) + list(jax.random.split(r_rng, M))
    draws = _JaxDraws(keys).install(tmodel)
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    assert not draws.keys and draws.shapes[2 * M] == (2, M, B, STYLE)
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        tmodel.compute_joint_nll(IncompleteDataset(*_arrays(seed=8)[:2]), K=K)


def _predict_keys(key):
    return list(jax.random.split(key, M))


def test_predict_clusters_matches_jax(shared_models):
    jmodel, tmodel = shared_models()
    data, _, _ = _arrays(seed=10, incomplete=False)
    key = jax.random.key(11)
    ref = jmodel.predict_clusters(data, rng=key, compute_lliks=True)
    _JaxDraws(_predict_keys(key)).install(tmodel)
    out = tmodel.predict_clusters(data, compute_lliks=True)
    np.testing.assert_array_equal(out.clusters.numpy(), np.asarray(ref.clusters))
    assert set(out.pc_zs) == set(DIMS)
    for m in DIMS:
        np.testing.assert_allclose(out.pc_zs[m].numpy(), np.asarray(ref.pc_zs[m]),
                                   err_msg=m, **VALUE_TOL)
    np.testing.assert_allclose(out.norm_lliks.numpy(), np.asarray(ref.norm_lliks),
                               **VALUE_TOL)
    _JaxDraws(_predict_keys(key)).install(tmodel)
    assert "norm_lliks" not in tmodel.predict_clusters(data)


def test_majority_vote_breaks_ties_toward_the_lowest_cluster(shared_models):
    """``np.bincount(row).argmax()`` of the JAX package: among the clusters
    with the most votes, the lowest index wins."""
    _, tmodel = shared_models()
    votes = {"m0": [3, 1, 4, 0], "m1": [1, 1, 2, 2], "m2": [2, 3, 0, 4]}

    def fixed_posteriors(mod, x):
        # a posterior concentrated far out on cluster ``votes[mod][row]``'s mean
        means = tmodel.mean_clusters.detach()[torch.tensor(votes[mod])]
        return {"embedding": means, "log_covariance": torch.full_like(means, -20.0)}

    tmodel.encode_mod = fixed_posteriors
    tmodel.mean_clusters.data *= 50.0
    tmodel.draw_noise = lambda shape, generator=None: torch.zeros(shape)
    data = {m: np.zeros((4, *d), np.float32) for m, d in DIMS.items()}
    out = tmodel.predict_clusters(data)
    expected = [np.bincount(row, minlength=C).argmax()
                for row in np.stack([votes[m] for m in DIMS], -1)]
    assert expected == [1, 1, 0, 0]
    np.testing.assert_array_equal(out.clusters.numpy(), expected)


def test_prune_clusters_matches_jax():
    """The host loop over a 10-row set in batches of 4 (the last one
    padded): the entropy per cluster count, the kept count and the pruned
    ``pc_params`` (-inf on the removed clusters)."""
    jmodel, tmodel = _models()
    data, _, _ = _arrays(seed=12, n=10, incomplete=False)
    key = jax.random.key(13)
    ref = jmodel.prune_clusters(JDataset(data), batch_size=4, rng=key)
    batch_keys = _chain(key, 3 * (C - 1))    # C-1 passes of 3 batches
    draws = _JaxDraws([k for sub in batch_keys for k in _predict_keys(sub)]).install(tmodel)
    out = tmodel.prune_clusters(MultimodalBaseDataset(data), batch_size=4)
    assert not draws.keys
    assert len(out) == C + 1 and out[:2] == [np.inf, np.inf] == ref[:2]
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert tmodel.n_clusters == jmodel.n_clusters >= 2
    pc, jpc = tmodel.pc_params.detach().numpy(), np.asarray(jmodel.params["model"]["pc_params"])
    np.testing.assert_array_equal(np.isinf(pc), np.isinf(jpc))
    assert np.isinf(pc).sum() == C - tmodel.n_clusters
    np.testing.assert_allclose(pc[np.isfinite(pc)], jpc[np.isfinite(jpc)], rtol=1e-6)


@pytest.mark.parametrize("loss", ["dreg_looser", "iwae_looser"])
def test_pruned_model_gives_the_same_non_finite_values_as_jax(loss):
    """A pruned cluster (``pc_params = -inf``) makes ``1e-20 * -inf`` terms
    in the objective: the JAX package's loss is nan or inf there and its
    joint NLL inf, and the port gives the same values. Cluster prediction
    and prior samples of the pruned model stay finite in both."""
    jmodel, tmodel = _models(pruned=(1,), K=3, loss=loss)
    arrays, key = _arrays(seed=14, incomplete=False), jax.random.key(15)
    ref, _ = _jax_loss(jmodel, arrays, key, grads=False)
    with torch.no_grad():
        value = _port_loss(tmodel, arrays, key).item()
    assert not np.isfinite(ref)
    np.testing.assert_equal(value, ref)

    data = arrays[0]
    if loss == "iwae_looser":
        return   # the NLL and the uses of a pruned model share no objective code
    ref_nll = float(jmodel.compute_joint_nll(data, K=3, batch_size_K=3, rng=key))
    (sub,) = _chain(key, 1)
    s_rng, r_rng = jax.random.split(sub)
    _JaxDraws(list(jax.random.split(s_rng, 2 * M)) + list(jax.random.split(r_rng, M))
              ).install(tmodel)
    nll = tmodel.compute_joint_nll(data, K=3, batch_size_K=3).item()
    assert ref_nll == np.inf
    np.testing.assert_equal(nll, ref_nll)

    _JaxDraws(_predict_keys(key)).install(tmodel)
    pred = tmodel.predict_clusters(data, compute_lliks=True)
    assert np.isfinite(pred.norm_lliks.numpy()).all() and (pred.clusters != 1).all()
    assert np.isfinite(np.asarray(jmodel.predict_clusters(data, rng=key,
                                                          compute_lliks=True).norm_lliks)).all()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        del tmodel.draw_noise, tmodel.draw_clusters
        prior = tmodel.generate_from_prior(64, generator=gen)
    assert torch.isfinite(prior.z).all()
    assert np.isfinite(np.asarray(jmodel.generate_from_prior(64, rng=key).z)).all()


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs(K=1, option="single_prior")
    jcfg, tcfg = JCMVAEConfig(**kw), CMVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert CMVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "CMVAEConfig"
    assert JCMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_default_nets_save_and_reload(tmp_path):
    dims = {"a": (5,), "b": (1, 2, 3)}
    model = CMVAE(CMVAEConfig(n_modalities=2, latent_dim=LATENT, K=2,
                              modalities_specific_dim=STYLE, input_dims=dims,
                              number_of_clusters=3), seed=3, device="cpu")
    assert isinstance(model.encoders["a"], default.Encoder_VAE_MLP_Style)
    data = {m: np.random.default_rng(0).uniform(size=(4, *d)).astype(np.float32)
            for m, d in dims.items()}
    out = model(data, generator=torch.Generator().manual_seed(0))
    assert out.loss.shape == () and torch.isfinite(out.loss)
    model.save(str(tmp_path))
    reloaded = CMVAE.load_from_folder(str(tmp_path), device="cpu")
    assert reloaded.n_clusters == 3
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
