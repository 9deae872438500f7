"""The port's GMM ops and latent samplers against the JAX package's, on the
CPU at a small size.

- ``ops/gmm.py`` against ``multivae_tpu/ops/gmm.py``: the component
  log-probabilities, the M-step, k-means from given centres, EM to
  convergence from given labels (weights, means, covariances, lower bound,
  ``n_iter``), sampling with the JAX draws, and the NaN factor of a
  component that is not positive definite;
- the samplers' contracts on the port's models: shapes,
  ``one_latent_space``, the private codes of a multi-latent model, the cut
  of ``n_components``, the refusals, fresh draws on each call, save and
  load, and the latents as ``model.encode`` gives them batch by batch;
- on incomplete data: the latents of MVTCAE, MVAE, CRMVAE, DMVAE and MHVAE
  (each row encoded from the modalities it has) against the JAX host
  loop's on the same draws, then the GMM and MAF fits on them; a mixture
  model (MMVAE) refuses, in both packages;
- the MAF and IAF fits against the JAX fit on the same plan (the final
  weights and the last loss), and ``sample`` with the JAX sampler's weights
  and the same u.

Tolerances: the GMM ops are float32 sums of 40-60 terms and a 3x3
Cholesky solve (rtol 1e-5, atol 1e-5); EM runs them for ``n_iter``
iterations (rtol 1e-4, atol 1e-5); a flow fit is 6 Adam steps, compared by
each tensor's move (``assert_same_moves``) and the last loss (rtol 1e-5).
"""

import itertools
import logging
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mhvae_test_architectures import build_mhvae_blocks
from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import CRMVAE as JCRMVAE
from multivae_tpu.models import DMVAE as JDMVAE
from multivae_tpu.models import MHVAE as JMHVAE
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MVAE as JMVAE
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import CRMVAEConfig as JCRMVAEConfig
from multivae_tpu.models import DMVAEConfig as JDMVAEConfig
from multivae_tpu.models import MHVAEConfig as JMHVAEConfig
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVAEConfig as JMVAEConfig
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.ops import flows as jflows
from multivae_tpu.ops import gmm as jgmm
from multivae_tpu.samplers import GaussianMixtureSampler as JGaussianMixtureSampler
from multivae_tpu.samplers import IAFSampler as JIAFSampler
from multivae_tpu.samplers import MAFSampler as JMAFSampler
from multivae_tpu.samplers import MAFSamplerConfig as JMAFSamplerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset
from multivae_tpu_torch.models import (
    CRMVAE,
    DMVAE,
    MHVAE,
    MMVAE,
    MVAE,
    MVTCAE,
    CRMVAEConfig,
    DMVAEConfig,
    MHVAEConfig,
    MMVAEConfig,
    MVAEConfig,
    MVTCAEConfig,
)
from multivae_tpu_torch.ops import gmm
from multivae_tpu_torch.samplers import (
    GaussianMixtureSampler,
    GaussianMixtureSamplerConfig,
    IAFSampler,
    IAFSamplerConfig,
    MAFSampler,
    MAFSamplerConfig,
)
from multivae_tpu_torch.samplers.maf_sampler.maf_sampler import fit_plan
from multivae_tpu_torch.utils.convert import flow_from_jax
from torch_parity import assert_same_moves, mhvae_mlp_blocks, normal, port_model

torch.set_num_threads(2)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
EM_TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = {"a": (5,), "b": (2, 3)}
LATENT = 3
PER_SAMPLE = {"MVTCAE": (JMVTCAE, JMVTCAEConfig, MVTCAE, MVTCAEConfig),
              "MVAE": (JMVAE, JMVAEConfig, MVAE, MVAEConfig),
              "CRMVAE": (JCRMVAE, JCRMVAEConfig, CRMVAE, CRMVAEConfig),
              "DMVAE": (JDMVAE, JDMVAEConfig, DMVAE, DMVAEConfig)}


def _blobs(n_per=20, k=3, d=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, d))
    return np.concatenate([c + rng.normal(size=(n_per, d)) * (0.5 + 0.5 * i)
                           for i, c in enumerate(centers)]).astype(np.float32)


def _spd(k, d, seed):
    a = np.random.default_rng(seed).normal(size=(k, d, d)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + d * np.eye(d, dtype=np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------- GMM ops
def test_log_prob_and_m_step_match_jax():
    X = _blobs()
    rng = np.random.default_rng(1)
    means, covs = rng.normal(size=(3, 3)).astype(np.float32), _spd(3, 3, 2)
    logits = rng.normal(size=(X.shape[0], 3)).astype(np.float32)
    log_resp = logits - np.log(np.exp(logits).sum(1, keepdims=True))

    @jax.jit
    def reference(X, means, covs, log_resp):
        chol = jnp.linalg.cholesky(covs)
        return (chol, jgmm._log_gaussian_prob(X, means, chol),
                jgmm._m_step(X, log_resp, 1e-6))

    jchol, jlog_prob, jm_step = reference(X, means, covs, log_resp)
    chol = gmm.cholesky(_t(covs))
    np.testing.assert_allclose(chol.numpy(), np.asarray(jchol), **OP_TOL)
    np.testing.assert_allclose(gmm._log_gaussian_prob(_t(X), _t(means), chol).numpy(),
                               np.asarray(jlog_prob), **OP_TOL)
    for ours, ref in zip(gmm._m_step(_t(X), _t(log_resp), 1e-6), jm_step):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **OP_TOL)


def test_kmeans_from_given_centres_matches_jax(monkeypatch):
    """Lloyd from the same centres (one of them far from every point, so
    that its cluster stays empty and keeps its centre)."""
    X = _blobs(seed=3)
    centers = np.stack([X[0], X[25], X[50], np.full(3, 100.0, np.float32)])
    monkeypatch.setattr(jgmm, "_kmeans_pp_init", lambda X, k, rng: jnp.asarray(centers))
    ref = np.asarray(jgmm._kmeans(jnp.asarray(X), 4, jax.random.key(0)))
    labels = gmm._kmeans(_t(X), _t(centers))
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert set(ref) == {0, 1, 2}
    # k-means++ draws its centres from the data
    seeded = gmm._kmeans_pp_init(_t(X), 3, torch.Generator().manual_seed(0))
    assert all((_t(X) == c).all(1).any() for c in seeded)


def test_em_from_given_labels_matches_jax(monkeypatch):
    k = 3
    X = _blobs(seed=4)
    labels = np.random.default_rng(5).integers(0, k, X.shape[0])
    monkeypatch.setattr(jgmm, "_kmeans", lambda X, k, rng: jnp.asarray(labels))
    ref = jgmm._fit_gmm_jit.__wrapped__(jnp.asarray(X), k, jax.random.key(0), 2000,
                                        1e-3, 1e-6)
    ours = gmm.fit_gmm(_t(X), k, labels=_t(labels))
    assert ours.n_iter == int(ref.n_iter) > 2
    for name in ("weights", "means", "covariances", "chol"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), err_msg=name, **EM_TOL)
    np.testing.assert_allclose(ours.lower_bound.item(), float(ref.lower_bound), **EM_TOL)
    np.testing.assert_allclose(gmm.score_samples(ours, _t(X)).numpy(),
                               np.asarray(jgmm.score_samples(ref, X)), **EM_TOL)
    # a cap on the iterations stops EM there
    assert gmm.fit_gmm(_t(X), k, labels=_t(labels), max_iter=2).n_iter == 2


def test_sampling_with_the_jax_draws_matches_jax():
    rng = np.random.default_rng(6)
    covs = _spd(3, 4, 7)
    params = jgmm.GMMParams(weights=jnp.asarray([0.2, 0.5, 0.3]),
                            means=jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
                            covariances=jnp.asarray(covs), chol=jnp.linalg.cholesky(covs),
                            lower_bound=jnp.zeros(()), n_iter=jnp.int32(1))
    key = jax.random.key(8)
    ref = np.asarray(jgmm.sample_gmm(params, key, 50))
    rng_c, rng_e = jax.random.split(key)
    comps = jax.random.categorical(rng_c, jnp.log(params.weights), shape=(50,))
    eps = normal(rng_e, (50, 4))
    ours = gmm.sample_gmm(gmm.GMMParams(*(_t(v) for v in params[:5]), 1), 50,
                          components=_t(comps), eps=eps)
    np.testing.assert_allclose(ours.numpy(), ref, **OP_TOL)
    drawn = gmm.sample_gmm(gmm.GMMParams(*(_t(v) for v in params[:5]), 1), 50,
                           torch.Generator().manual_seed(0))
    assert drawn.shape == (50, 4) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("bad", ["indefinite", "singular"])
def test_a_factor_that_is_not_positive_definite_is_nan_like_jax(bad):
    """``jnp.linalg.cholesky`` gives NaN for a matrix that is not positive
    definite (on and below the diagonal), where ``torch.linalg.cholesky``
    raises: the port gives the same, for that component alone, indefinite or
    singular."""
    covs = _spd(3, 3, 9)
    covs[1] = np.diag([1.0, -1.0, 1.0]) if bad == "indefinite" else np.zeros((3, 3))
    ref = np.asarray(jnp.linalg.cholesky(covs))
    chol = gmm.cholesky(_t(covs)).numpy()
    np.testing.assert_array_equal(np.isnan(chol), np.isnan(ref))
    assert np.isnan(chol[1][np.tril_indices(3)]).all() and not np.triu(chol[1], 1).any()
    assert not np.isnan(chol[[0, 2]]).any()
    np.testing.assert_allclose(chol[[0, 2]], ref[[0, 2]], **OP_TOL)
    X = _blobs(n_per=3)
    log_prob = gmm._log_gaussian_prob(_t(X), torch.zeros(3, 3), _t(chol)).numpy()
    jlog_prob = np.asarray(jgmm._log_gaussian_prob(X, np.zeros((3, 3), np.float32), ref))
    np.testing.assert_array_equal(np.isnan(log_prob), np.isnan(jlog_prob))
    assert np.isnan(log_prob[:, 1]).all()


# ------------------------------------------------------- sampler contracts
@pytest.fixture(scope="module")
def models():
    """A single-latent model (MVTCAE) and a multi-latent one (DMVAE with
    private dims 1 and 2, so that a flow of input_dim 1 is fitted), and 20
    rows of data."""
    rng = np.random.default_rng(0)
    data = {m: rng.uniform(size=(20, *d)).astype(np.float32) for m, d in DIMS.items()}
    common = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS)
    single = MVTCAE(MVTCAEConfig(**common), device="cpu")
    multi = DMVAE(DMVAEConfig(modalities_specific_dim={"a": 1, "b": 2}, **common),
                  device="cpu")
    return single, multi, MultimodalBaseDataset(data)


def _samplers(model):
    return [GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(n_components=2)),
            MAFSampler(model, MAFSamplerConfig(hidden_size=8)),
            IAFSampler(model, IAFSamplerConfig(hidden_size=8, n_hidden_in_made=1))]


def _fit(sampler, dataset):
    if isinstance(sampler, MAFSampler):
        sampler.fit(dataset, num_epochs=2, batch_size=8)
    else:
        sampler.fit(dataset)
    return sampler


@pytest.mark.parametrize("multi", [False, True])
def test_sampler_contracts(models, multi):
    model = models[multi]
    for sampler in _samplers(model):
        with pytest.raises(ArithmeticError, match="fitted"):
            sampler.sample(3)
        _fit(sampler, models[2])
        out = sampler.sample(11)
        assert out.z.shape == (11, LATENT) and out.one_latent_space is not multi
        assert torch.isfinite(out.z).all()
        if multi:
            assert {m: tuple(v.shape) for m, v in out.modalities_z.items()} == {
                "a": (11, 1), "b": (11, 2)}
        else:
            assert "modalities_z" not in out
        decoded = model.decode(out, "b")
        assert decoded["b"].shape == (11, 2, 3)
        # fresh draws on each call
        assert not torch.equal(sampler.sample(5).z, sampler.sample(5).z), sampler.name


def test_collected_latents_are_the_encodes_in_order(models):
    """Batches of 8 over 20 rows (the last one padded): the padding rows are
    dropped and the rows keep their order."""
    model, dataset = models[1], models[2]
    sampler = GaussianMixtureSampler(model)
    model.draw_noise = lambda shape, generator=None: torch.zeros(shape)
    try:
        z, mod_z = sampler._collect_latents(dataset, batch_size=8)
        ref = model.encode(dataset[:], return_mean=True)
    finally:
        del model.draw_noise
    assert z.shape == (20, LATENT) and not z.requires_grad
    torch.testing.assert_close(z, ref.z)
    for m in DIMS:
        torch.testing.assert_close(mod_z[m], ref.modalities_z[m])


def test_gmm_sampler_cuts_components_and_backends(models, caplog):
    model, dataset = models[0], models[2]
    sampler = GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(n_components=50))
    with caplog.at_level(logging.WARNING):
        sampler.fit(dataset)
    assert sampler.n_components == 20 and "n_components > n_samples" in caplog.text
    assert sampler.gmm.weights.shape == (20,)
    # "jax", the JAX package's name for the device fit, is the same fit
    fits = {}
    for backend in ("torch", "jax", "sklearn"):
        s = GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(
            n_components=2, fit_backend=backend))
        model.draw_noise = lambda shape, generator=None: torch.zeros(shape)
        try:
            s.fit(dataset)
        finally:
            del model.draw_noise
        fits[backend] = s
        assert s.sample(4).z.shape == (4, LATENT)
    assert torch.equal(fits["torch"].gmm.means, fits["jax"].gmm.means)
    assert fits["sklearn"].gmm.means_.shape == (2, LATENT)
    with pytest.raises(ValueError, match="fit_backend"):
        GaussianMixtureSamplerConfig(fit_backend="numpy")


def _incomplete(dataset, n=20):
    """``dataset``'s rows with 'a' missing in rows 3 and 9, 'b' in 4 and 9
    (row 9 has no modality), missing entries zeroed."""
    masks = {m: np.ones(n, bool) for m in DIMS}
    masks["a"][[3, 9]] = False
    masks["b"][[4, 9]] = False
    data = {m: np.where(masks[m].reshape(-1, *(1,) * (v.ndim - 1)), v, 0.0).astype(np.float32)
            for m, v in dataset.data.items()}
    return data, masks


def test_samplers_refuse_incomplete_data(models):
    """A mixture model (MMVAE: one expert drawn for the whole batch) keeps
    ``encode``'s availability error on an incomplete dataset, in both
    packages; complete masks are fine."""
    dataset = models[2]
    common = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS)
    model = MMVAE(MMVAEConfig(**common), device="cpu")
    assert not model.supports_per_sample_conditioning
    incomplete = IncompleteDataset(*_incomplete(dataset))
    for sampler in _samplers(model):
        with pytest.raises(AttributeError, match="incomplete dataset"):
            _fit(sampler, incomplete)
    with pytest.raises(AttributeError, match="cannot condition each row"):
        model.encode_per_sample(incomplete[:])
    with pytest.raises(AttributeError, match="incomplete dataset"):
        JGaussianMixtureSampler(JMMVAE(JMMVAEConfig(**common)))._collect_latents(
            JIncompleteDataset(*_incomplete(dataset)), batch_size=8)
    full = IncompleteDataset(dataset.data, {m: np.ones(20, bool) for m in DIMS})
    assert _fit(_samplers(model)[0], full).is_fitted


def _per_sample_models(name):
    """(JAX model, the port's with its weights) of a per-sample family."""
    common = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS)
    if name == "MHVAE":
        jblocks = build_mhvae_blocks(DIMS, n_latent=3, latent_dim=LATENT,
                                     shared_posteriors=False)
        names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
                 "posterior_blocks", "prior_blocks")
        jmodel = JMHVAE(JMHVAEConfig(**common), **dict(zip(names, jblocks)))
        jmodel.init_params_with_batch(j_batch_from_arrays(
            data={m: np.zeros((2, *d), np.float32) for m, d in DIMS.items()}))
        tmodel = MHVAE(MHVAEConfig(**common), **dict(zip(
            names, mhvae_mlp_blocks(DIMS, LATENT, shared=False))), device="cpu")
        return jmodel, port_model(jmodel, tmodel)
    if name == "DMVAE":
        common["modalities_specific_dim"] = {"a": 1, "b": 2}
    jcls, jcfg, cls, cfg = PER_SAMPLE[name]
    return jcls(jcfg(**common)), port_model(jcls(jcfg(**common)), cls(cfg(**common),
                                                                       device="cpu"))


def _collect_noise(name, key):
    """The ``draw_noise`` hook of the JAX host loop's per-batch masked
    encode: every batch draws from ``key`` again. MVTCAE, MVAE and CRMVAE
    draw z from ``key``; DMVAE z from ``split(key)[1]``, then each private
    code from ``split(split(key)[0], 2)``; MHVAE each level from the chain
    ``rng, z_rng = split(rng)``, the deepest first."""
    if name == "MHVAE":
        keys, rng = [], key
        for _ in range(3):
            rng, sub = jax.random.split(rng)
            keys.append(sub)
    elif name == "DMVAE":
        rng, z_rng = jax.random.split(key)
        keys = [z_rng, *jax.random.split(rng, 2)]
    else:
        keys = [key]
    draws = itertools.cycle(keys)
    return lambda shape, generator=None: normal(next(draws), shape)


@pytest.mark.parametrize("name", ["MVTCAE", "MVAE", "CRMVAE", "DMVAE", "MHVAE"])
def test_latents_collected_on_incomplete_data_match_jax(models, name):
    """20 rows in batches of 8 (the last one padded), rows missing 'a',
    'b' or both: each row is encoded from the modalities it has (DMVAE's
    private code of a missing modality from N(0, I)), as the JAX host loop
    does; then the GMM and MAF samplers fit on them."""
    jmodel, tmodel = _per_sample_models(name)
    assert tmodel.supports_per_sample_conditioning and jmodel.supports_per_sample_conditioning
    data, masks = _incomplete(models[2])
    key = jax.random.key(4)
    ref_z, ref_mods = JGaussianMixtureSampler(jmodel)._collect_latents(
        JIncompleteDataset(data, masks), batch_size=8, rng=key)
    dataset = IncompleteDataset(data, masks)
    tmodel.draw_noise = _collect_noise(name, key)
    z, mod_z = GaussianMixtureSampler(tmodel)._collect_latents(dataset, batch_size=8)
    assert z.shape == (20, LATENT)
    np.testing.assert_allclose(z.numpy(), ref_z, **OP_TOL)
    assert (mod_z is None) == (ref_mods is None) == (name != "DMVAE")
    if name == "DMVAE":
        for m in DIMS:
            np.testing.assert_allclose(mod_z[m].numpy(), ref_mods[m], err_msg=m, **OP_TOL)
        with torch.no_grad():
            prior = _collect_noise(name, key)
            draws = [prior((8, LATENT)), prior((8, 1)), prior((8, 2))]
        # row 9 (the second batch's row 1) lacks both: its private codes are the noise
        assert torch.equal(mod_z["a"][9], draws[1][1]) and torch.equal(mod_z["b"][9],
                                                                       draws[2][1])
    del tmodel.draw_noise
    for sampler in _samplers(tmodel)[:2]:
        out = _fit(sampler, dataset).sample(5)
        assert out.z.shape == (5, LATENT) and torch.isfinite(out.z).all()


# ------------------------------------------------------ flow fits vs JAX
def _stub(latent_dim):
    """What the samplers read of a model, on the CPU."""
    return types.SimpleNamespace(model_config=types.SimpleNamespace(latent_dim=latent_dim),
                                 multiple_latent_spaces=False, device=torch.device("cpu"))


@pytest.mark.parametrize("cls", ["MAF", "IAF"])
def test_flow_fit_and_sample_match_jax(tmp_path, cls):
    """20 latents of D=3, 2 epochs in batches of 8 (the third batch of each
    epoch padded), Adam 1e-3, from the JAX sampler's initial weights."""
    jcls, tcls = ((JMAFSampler, MAFSampler) if cls == "MAF" else (JIAFSampler, IAFSampler))
    config = dict(hidden_size=8, n_hidden_in_made=2)
    data = np.random.default_rng(3).normal(size=(20, LATENT)).astype(np.float32)
    jsampler = jcls(_stub(LATENT), JMAFSamplerConfig(**config))
    key = jax.random.key(4)
    init = jax.jit(jsampler.flows_models["shared"].init)(key, jnp.zeros((1, LATENT)))
    params = jsampler._fit_one_flow("shared", data, 2, 8, 1e-3, key)
    # the package's compiled fit again, for its last loss, on the port's plan
    idx, w = fit_plan(20, 2, 8)
    again, jloss = jsampler._jit_cache[("fit", "shared", 1e-3)](
        init, optax.adam(1e-3).init(init), jnp.asarray(data), jnp.asarray(idx),
        jnp.asarray(w))
    start, ref = flow_from_jax(init), flow_from_jax(params)
    for name, v in flow_from_jax(again).items():
        assert torch.equal(v, ref[name]), name

    sampler = tcls(_stub(LATENT), (MAFSamplerConfig if cls == "MAF" else IAFSamplerConfig)(
        **config))
    sampler.flows_models["shared"].load_state_dict(start)
    sampler._fit_one_flow("shared", _t(data), 2, 8, 1e-3)
    sampler.is_fitted = True
    assert_same_moves(sampler.flows_models["shared"].state_dict(), ref, start, 1e-3)
    np.testing.assert_allclose(sampler.last_loss["shared"], float(jloss), rtol=1e-5)

    # sample: the same u through the JAX sampler's weights
    sampler.flows_models["shared"].load_state_dict(ref)
    u = normal(jax.random.key(5), (6, LATENT))
    jflow = jsampler.flows_models["shared"]
    z_ref = np.asarray(jax.jit(lambda p, u: jflow.apply(
        p, u, method=type(jflow).inverse)["out"])(params, u.numpy()))
    sampler.draw_noise = lambda shape, generator=None: u
    np.testing.assert_allclose(sampler.sample(6).z.numpy(), z_ref, rtol=1e-5, atol=1e-5)
    assert isinstance(jflow, getattr(jflows, cls))

    # save / load
    sampler.save(str(tmp_path))
    loaded = tcls(_stub(LATENT), sampler.sampler_config)
    loaded.load_flows_from_folder(str(tmp_path))
    loaded.draw_noise = sampler.draw_noise
    assert torch.equal(loaded.sample(6).z, sampler.sample(6).z)
    with pytest.raises(AttributeError, match="load the flows"):
        loaded.load_flows_from_folder(str(tmp_path / "missing"))
    with pytest.raises(ArithmeticError, match="fitted"):
        tcls(_stub(LATENT)).save(str(tmp_path / "unfitted"))
