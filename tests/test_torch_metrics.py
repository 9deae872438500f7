"""The port's evaluators (``multivae_tpu_torch.metrics``) against the JAX
package's, on the CPU at a small size: MLP ``MVTCAE`` and ``MMVAE``
(Laplace posteriors) of latent 6 and hidden 16 on 2 image modalities of
1x12x12 and 3x12x12, 30 rows of 3 classes in batches of 12, so that the
last batch is padded.

The JAX evaluators run their per-subset loop (``fused_sweep=False``) with
the test set on the host. Their models' keys are logged in call order
(``torch_parity.record_keys``) and the port's models draw the same numbers
through ``torch_parity.JaxCallDraws``. Classifiers are linear maps of the
flattened modality with the same weights on both sides.

Tolerances: metric values are sums and means of float32 terms taken in
another order (rtol 1e-5, atol 1e-6, ``VALUE_TOL``); an NLL sums ~10^3
log-weights of ~10^2 (``NLL_TOL``, as in ``test_torch_mvtcae.py``).
Accuracies and cluster accuracies are counts: exactly equal. That holds
here because no classifier logit's top two are within 1e-4 of each other
on these inputs; ``test_coherence_classifier_margins_leave_no_near_tie``
pins it.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multivae_tpu.metrics.visualization.visualization_class as jvis
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.utils import adapt_shape as j_adapt_shape
from multivae_tpu.data.utils import grid_to_pil, make_grid as j_make_grid
from multivae_tpu.metrics import (
    Clustering as JClustering,
    ClusteringConfig as JClusteringConfig,
    CoherenceEvaluator as JCoherence,
    CoherenceEvaluatorConfig as JCoherenceConfig,
    LikelihoodsEvaluator as JLikelihoods,
    LikelihoodsEvaluatorConfig as JLikelihoodsConfig,
    Reconstruction as JReconstruction,
    ReconstructionConfig as JReconstructionConfig,
    Visualization as JVisualization,
    VisualizationConfig as JVisualizationConfig,
)
from multivae_tpu.metrics.base.subset_sweep import all_subsets as j_all_subsets
from multivae_tpu.metrics.classifiers.mmnist import (
    ClassifierPolyMNIST as JClassifier,
    convert_torch_classifier_state_dict,
)
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MoPoE as JMoPoE
from multivae_tpu.models import MoPoEConfig as JMoPoEConfig
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.ops import gmm as jgmm
from multivae_tpu.ops.ssim import ssim as j_ssim
from multivae_tpu.samplers import GaussianMixtureSampler as JGaussianMixtureSampler
from multivae_tpu_torch.data import MultimodalBaseDataset, ResampleDataset, random_split
from multivae_tpu_torch.data.utils import adapt_shape, grid_to_image, make_grid
from multivae_tpu_torch.metrics import (
    ClassifierPolyMNIST,
    Clustering,
    ClusteringConfig,
    CoherenceEvaluator,
    CoherenceEvaluatorConfig,
    LikelihoodsEvaluator,
    LikelihoodsEvaluatorConfig,
    Reconstruction,
    ReconstructionConfig,
    Visualization,
    VisualizationConfig,
)
from multivae_tpu_torch.metrics.base import all_subsets
from multivae_tpu_torch.models import (
    MMVAE,
    MVTCAE,
    MMVAEConfig,
    MoPoE,
    MoPoEConfig,
    MVTCAEConfig,
)
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops import gmm
from multivae_tpu_torch.ops.kmeans import KMeans, kmeans_plusplus
from multivae_tpu_torch.ops.ssim import ssim
from multivae_tpu_torch.samplers import GaussianMixtureSampler
from multivae_tpu_torch.utils.convert import classifier_from_jax
from torch_parity import JaxCallDraws, chain, normal, port_model, record_keys

torch.set_num_threads(2)

DIMS = {"m0": (1, 12, 12), "m1": (3, 12, 12)}
LATENT, HID, N_ROWS, BATCH, N_CLASSES = 6, 16, 30, 12, 3
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
NLL_TOL = dict(rtol=1e-5, atol=1e-4)
# the JAX evaluators' host path: per-subset loop, test set on the host
J_COMMON = dict(batch_size=BATCH, cache_on_device=False)


def _nets(lib):
    enc_cls, dec_cls, cfg = ((JEncoder, JDecoder, JAEConfig) if lib == "jax"
                             else (Encoder_VAE_MLP, Decoder_AE_MLP, BaseAEConfig))
    return ({m: enc_cls(cfg(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
             for m, d in DIMS.items()},
            {m: dec_cls(cfg(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
             for m, d in DIMS.items()})


def _pair(family):
    """(JAX model, the port's with its weights) of ``family``."""
    common = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS,
                  decoders_dist={m: "laplace" for m in DIMS})
    if family == "mmvae":
        kw = dict(common, K=3, prior_and_posterior_dist="laplace_with_softmax")
        jmodel = JMMVAE(JMMVAEConfig(**kw), *_nets("jax"), seed=1)
        tmodel = MMVAE(MMVAEConfig(**kw), *_nets("torch"), device="cpu")
    else:
        jmodel = JMVTCAE(JMVTCAEConfig(**common), *_nets("jax"), seed=1)
        tmodel = MVTCAE(MVTCAEConfig(**common), *_nets("torch"), device="cpu")
    return jmodel, port_model(jmodel, tmodel)


@pytest.fixture(scope="module")
def world():
    """Both model pairs, 30 labelled rows (and 40 training rows for the
    clustering), and linear 3-class classifiers."""
    rng = np.random.default_rng(0)
    data = {m: rng.uniform(size=(N_ROWS, *d)).astype(np.float32) for m, d in DIMS.items()}
    labels = rng.integers(0, N_CLASSES, N_ROWS)
    train = {m: rng.uniform(size=(40, *d)).astype(np.float32) for m, d in DIMS.items()}
    train_labels = rng.integers(0, N_CLASSES, 40)
    weights = {m: (rng.normal(size=(math.prod(d), N_CLASSES)) * 0.5).astype(np.float32)
               for m, d in DIMS.items()}
    return dict(
        models={f: _pair(f) for f in ("mvtcae", "mmvae")},
        data=data, labels=labels, train=train, train_labels=train_labels,
        jclfs={m: (lambda x, w=w: jnp.asarray(x).reshape(len(x), -1) @ w)
               for m, w in weights.items()},
        tclfs={m: (lambda x, w=torch.tensor(w): x.flatten(1) @ w)
               for m, w in weights.items()},
    )


def _run(world, family, make_j, make_t, seed=3):
    """Build and run the JAX evaluator (``make_j(jmodel)`` returns the
    evaluator and its call), then the port's on the same draws."""
    jmodel, tmodel = world["models"][family]
    jmodel.set_seed(seed)
    keys = record_keys(jmodel)
    try:
        ref = make_j(jmodel)()
    finally:
        del jmodel.next_rng
    feed = JaxCallDraws(tmodel, keys, mixture=family == "mmvae")
    try:
        out = make_t(tmodel)()
    finally:
        for name in (*JaxCallDraws.CALLS, "draw_noise", "draw_expert"):
            tmodel.__dict__.pop(name, None)
    assert not feed.keys, f"{len(feed.keys)} JAX keys left unused"
    return ref, out


def _datasets(world, port):
    cls = MultimodalBaseDataset if port else JDataset
    return cls(world["data"], labels=world["labels"])


def _assert_metrics_close(ours, ref, tol=VALUE_TOL):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **tol)


# ------------------------------------------------------------ likelihoods
@pytest.mark.parametrize("family,unified", [("mvtcae", True), ("mmvae", True),
                                            ("mmvae", False)])
def test_likelihoods_match_jax(world, family, unified):
    """Unified NLLs of both families and MMVAE's paper NLL (one value a
    row, the padding rows masked by the evaluator)."""
    def make(lib):
        def build(model):
            if lib == "jax":
                ev = JLikelihoods(model, _datasets(world, False), eval_config=JLikelihoodsConfig(
                    num_samples=5, batch_size_k=2, unified_implementation=unified,
                    **J_COMMON))
            else:
                ev = LikelihoodsEvaluator(model, _datasets(world, True),
                                          eval_config=LikelihoodsEvaluatorConfig(
                                              batch_size=BATCH, num_samples=5,
                                              batch_size_k=2,
                                              unified_implementation=unified))
            return ev.eval
        return build

    ref, out = _run(world, family, make("jax"), make("torch"))
    assert set(out) == {"joint_likelihood"} and np.isfinite(out.joint_likelihood)
    _assert_metrics_close(out, ref, NLL_TOL)


def test_likelihoods_ignore_padding_rows(world):
    """The same 30 rows in batches of 12 (6 padding rows) and of 10 (none)
    give the same mean NLL on the same per-row draws: MMVAE's paper NLL
    draws the noise of each row independently of the batch (a fixed
    Uniform per (sample, row, coordinate))."""
    _, tmodel = world["models"]["mmvae"]
    table = torch.rand((5, N_ROWS, LATENT), generator=torch.Generator().manual_seed(0)) - 0.5
    table = torch.cat([table, table], 1)   # the padding rows wrap around

    def run(batch_size):
        rows = iter(range(0, N_ROWS, batch_size))
        state = {}

        def noise(shape, generator=None):
            return table[:shape[0], state["start"]:state["start"] + shape[1]]

        def paper(inputs, K=1000, batch_size_K=10, generator=None):
            state["start"] = next(rows)
            return type(tmodel).compute_joint_nll_paper(tmodel, inputs, K, batch_size_K,
                                                        generator)

        tmodel.draw_noise, tmodel.compute_joint_nll_paper = noise, paper
        try:
            return LikelihoodsEvaluator(tmodel, _datasets(world, True),
                                        eval_config=LikelihoodsEvaluatorConfig(
                                            batch_size=batch_size, num_samples=5,
                                            batch_size_k=5,
                                            unified_implementation=False)).eval()
        finally:
            del tmodel.draw_noise, tmodel.compute_joint_nll_paper

    np.testing.assert_allclose(run(12).joint_likelihood, run(10).joint_likelihood,
                               **VALUE_TOL)


def test_likelihood_from_a_subset_matches_jax(world):
    """MoPoE's NLL with one subset's PoE as the importance distribution
    (its chunks draw z from the second key of each chain key's 3-way
    split); None for a model without it."""
    common = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS)
    jmodel = JMoPoE(JMoPoEConfig(**common), *_nets("jax"), seed=1)
    tmodel = port_model(jmodel, MoPoE(MoPoEConfig(**common), *_nets("torch"),
                                      device="cpu"))
    rng = np.random.default_rng(7)
    data = {m: rng.uniform(size=(N_ROWS, *d)).astype(np.float32) for m, d in DIMS.items()}
    cfg = dict(num_samples=5, batch_size_k=2)
    jmodel.set_seed(3)
    keys = record_keys(jmodel)
    ref = JLikelihoods(jmodel, JDataset(data), eval_config=JLikelihoodsConfig(
        **cfg, **J_COMMON)).joint_nll_from_subset(["m1"])
    chunk_keys = iter(())
    subset_nll = tmodel._compute_joint_nll_from_subset_encoding

    def fed(*args, **kwargs):
        nonlocal chunk_keys
        chunk_keys = (jax.random.split(sub, 3)[1] for sub in chain(keys.pop(0), 3))
        return subset_nll(*args, **kwargs)

    tmodel._compute_joint_nll_from_subset_encoding = fed
    tmodel.draw_noise = lambda shape, generator=None: normal(next(chunk_keys), shape)
    ev = LikelihoodsEvaluator(tmodel, MultimodalBaseDataset(data),
                              eval_config=LikelihoodsEvaluatorConfig(batch_size=BATCH, **cfg))
    out = ev.joint_nll_from_subset(["m1"])
    assert not keys and ev.metrics == {"Joint likelihood from subset ['m1']": out}
    np.testing.assert_allclose(out, ref, **NLL_TOL)
    mvtcae = world["models"]["mvtcae"][1]
    assert LikelihoodsEvaluator(mvtcae, MultimodalBaseDataset(data)).joint_nll_from_subset(
        ["m1"]) is None


# ------------------------------------------------------------- coherences
def _coherence(world, family, sampler=None, joint_only=False, **cfg):
    """The JAX and the port's coherences: ``eval``, or with ``joint_only``
    the joint coherence alone (through the JAX fused path, the one that
    gives a single draw its batch axis)."""
    cfg.setdefault("nb_samples_for_joint", 26)

    def build_j(model):
        ev = JCoherence(model, world["jclfs"], _datasets(world, False),
                        eval_config=JCoherenceConfig(num_classes=N_CLASSES,
                                                     fused_sweep=joint_only, **cfg,
                                                     **J_COMMON),
                        sampler=None if sampler is None else sampler[0])
        return (lambda: {"joint": ev.joint_coherence()}) if joint_only else ev.eval

    def build_t(model):
        ev = CoherenceEvaluator(model, world["tclfs"], _datasets(world, True),
                                eval_config=CoherenceEvaluatorConfig(
                                    batch_size=BATCH, num_classes=N_CLASSES, **cfg),
                                sampler=None if sampler is None else sampler[1])
        return (lambda: {"joint": ev.joint_coherence()}) if joint_only else ev.eval

    return _run(world, family, build_j, build_t)


@pytest.mark.parametrize("family,cfg", [
    ("mvtcae", {}),
    ("mmvae", {}),
    ("mvtcae", {"include_recon": True}),
    ("mmvae", {"nb_samples_for_cross": 2, "give_details_per_class": True}),
])
def test_coherences_match_jax(world, family, cfg):
    """Cross coherences (with the subset's own modalities under
    ``include_recon``; 2 draws a row; per class), and the joint coherence
    from the prior in chunks of 12, 12 and 2."""
    ref, out = _coherence(world, family, **cfg)
    assert "joint_coherence_prior" in out and "m0_to_m1" in out
    assert ("m0_to_m0" in out) == cfg.get("include_recon", False)
    assert ("mean_coherence_1_class_2" in out) == cfg.get("give_details_per_class", False)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=0, abs=1e-12), k


@pytest.mark.parametrize("family", ["mvtcae", "mmvae"])
def test_joint_coherence_of_a_single_draw_matches_jax(world, family):
    """13 joint samples in chunks of 12 and 1: the single draw,
    ``generate_from_prior(1)``'s (latent,), is decoded as a batch of one,
    as the JAX package's fused path does (its per-modality loop would feed
    the classifiers unbatched images)."""
    ref, out = _coherence(world, family, joint_only=True, nb_samples_for_joint=13)
    assert out["joint"] == ref["joint"]


def test_coherence_classifier_margins_leave_no_near_tie(world):
    """The exact accuracy comparisons rest on logits whose top two are
    further apart than float32 noise: at least 1e-4 on every prediction the
    port's coherence evaluation makes."""
    _, tmodel = world["models"]["mvtcae"]
    margins = []

    def recording(clf):
        def call(x):
            logits = clf(x)
            top2 = logits.topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            return logits
        return call

    CoherenceEvaluator(tmodel, {m: recording(c) for m, c in world["tclfs"].items()},
                       _datasets(world, True),
                       eval_config=CoherenceEvaluatorConfig(
                           batch_size=BATCH, num_classes=N_CLASSES, nb_samples_for_joint=25,
                           include_recon=True),
                       generator=torch.Generator().manual_seed(3)).eval()
    assert min(margins) > 1e-4


def test_joint_coherence_from_a_gmm_sampler_matches_jax(world):
    """A fitted 2-component mixture in the JAX sampler and in the port's,
    which draws the JAX sampler's components and noise."""
    jmodel, tmodel = world["models"]["mvtcae"]
    rng = np.random.default_rng(6)
    factors = rng.normal(scale=0.4, size=(2, LATENT, LATENT)) + 2 * np.eye(LATENT)
    covs = (factors @ factors.transpose(0, 2, 1)).astype(np.float32)
    params = jgmm.GMMParams(
        weights=jnp.asarray([0.3, 0.7]), means=jnp.asarray(rng.normal(size=(2, LATENT)),
                                                          jnp.float32),
        covariances=jnp.asarray(covs), chol=jnp.linalg.cholesky(covs),
        lower_bound=jnp.zeros(()), n_iter=jnp.int32(1))
    jsampler = JGaussianMixtureSampler(jmodel)
    jsampler.gmm, jsampler.is_fitted = params, True
    tsampler = GaussianMixtureSampler(tmodel)
    tparams = gmm.GMMParams(*(torch.tensor(np.asarray(v)) for v in params[:5]), 1)
    tsampler.gmm, tsampler.is_fitted = tparams, True
    calls = iter(range(1, 100))

    def draw(g, n):
        rng_c, rng_e = jax.random.split(jax.random.fold_in(
            jax.random.key(jsampler.seed), next(calls)))
        comps = jax.random.categorical(rng_c, jnp.log(params.weights), shape=(n,))
        return gmm.sample_gmm(g, n, components=torch.tensor(np.asarray(comps)),
                              eps=normal(rng_e, (n, LATENT)))

    tsampler._draw = draw
    ref, out = _coherence(world, "mvtcae", sampler=(jsampler, tsampler))
    assert "joint_coherence_GaussianMixtureSampler" in out
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=0, abs=1e-12), k


def test_coherence_refuses_a_dataset_without_labels(world):
    _, tmodel = world["models"]["mvtcae"]
    ev = CoherenceEvaluator(tmodel, world["tclfs"], MultimodalBaseDataset(world["data"]),
                            eval_config=CoherenceEvaluatorConfig(num_classes=N_CLASSES))
    with pytest.raises(AttributeError, match="without labels"):
        ev.cross_coherences()
    with pytest.raises(AttributeError, match="number of classes"):
        CoherenceEvaluator(tmodel, world["tclfs"], _datasets(world, True),
                           eval_config=CoherenceEvaluatorConfig(num_classes=None))


# --------------------------------------------------------- reconstruction
@pytest.mark.parametrize("metric", ["MSE", "SSIM"])
@pytest.mark.parametrize("family", ["mvtcae", "mmvae"])
def test_reconstruction_matches_jax(world, family, metric):
    """The joint subset's and each modality's SSIM (weighted by each
    batch's real rows) or MSE (per row)."""
    def build_j(model):
        return JReconstruction(model, _datasets(world, False), eval_config=JReconstructionConfig(
            metric=metric, fused_sweep=False, **J_COMMON)).eval

    def build_t(model):
        return Reconstruction(model, _datasets(world, True), eval_config=ReconstructionConfig(
            batch_size=BATCH, metric=metric)).eval

    ref, out = _run(world, family, build_j, build_t)
    assert len(out) == 3 and f"['m0'] reconstruction error ({metric})" in out
    _assert_metrics_close(out, ref)


def test_ssim_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(4, 3, 16, 14)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    for reduce in (True, False):
        ours = ssim(torch.tensor(a), torch.tensor(b), reduce=reduce).numpy()
        ref = np.asarray(j_ssim(a, b, reduce=reduce))
        assert ours.shape == ref.shape == (() if reduce else (4,))
        np.testing.assert_allclose(ours, ref, **VALUE_TOL)
    gray = ssim(torch.tensor(a[:, 0]), torch.tensor(b[:, 0]), data_range=2.0)
    np.testing.assert_allclose(gray.numpy(), np.asarray(j_ssim(a[:, 0], b[:, 0],
                                                               data_range=2.0)), **VALUE_TOL)


# ------------------------------------------------------------- clustering
def _blobs():
    rng = np.random.default_rng(2)
    centres = rng.normal(scale=8.0, size=(4, 5))
    return (centres[rng.integers(0, 4, 200)] + rng.normal(size=(200, 5))).astype(np.float32)


def _sklearn_kmeans(X, init):
    from sklearn.cluster import KMeans as SKMeans

    return SKMeans(n_clusters=len(init), init=np.asarray(init), n_init=1,
                   max_iter=300).fit(X)


@pytest.mark.parametrize("source", ["blobs", "latents"])
def test_kmeans_matches_sklearn_from_the_same_centres(world, source):
    """From the same initial centres (the port's k-means++), the port's
    Lloyd iterations give scikit-learn's labels, centres and iteration
    count, on separated blobs and on an MLP model's latents."""
    if source == "blobs":
        X, k = _blobs(), 4
    else:
        _, tmodel = world["models"]["mvtcae"]
        with torch.no_grad():
            X = tmodel.encode(MultimodalBaseDataset(world["train"]), return_mean=True).z
        X, k = X.numpy(), 3
    init = kmeans_plusplus(torch.tensor(X), k, torch.Generator().manual_seed(0))
    ours = KMeans(n_clusters=k, init=init).fit(torch.tensor(X))
    ref = _sklearn_kmeans(X, init.numpy())
    np.testing.assert_array_equal(ours.labels_.numpy(), ref.labels_)
    np.testing.assert_allclose(ours.cluster_centers_.numpy(), ref.cluster_centers_,
                               rtol=0, atol=1e-5)
    assert ours.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(ours.predict(torch.tensor(X[:17])).numpy(),
                                  ref.predict(X[:17]))


def test_kmeans_plusplus_seeds_distinct_rows_and_the_default_fit_separates_blobs():
    X = torch.tensor(_blobs())
    init = kmeans_plusplus(X, 4, torch.Generator().manual_seed(5))
    rows = [(X == c).all(1).nonzero().flatten().tolist() for c in init]
    assert all(len(r) == 1 for r in rows) and len({r[0] for r in rows}) == 4
    labels = KMeans(4, generator=torch.Generator().manual_seed(1)).fit_predict(X)
    ref = _sklearn_kmeans(X.numpy(), init.numpy()).labels_
    # the same partition up to the names of the clusters
    assert len({(a, b) for a, b in zip(labels.tolist(), ref)}) == 4
    with pytest.raises(ValueError, match="n_clusters"):
        KMeans(5).fit(X[:3])


def test_kmeans_predicts_from_the_fits_mean():
    """Rows far from the origin next to their spread (a briefly trained
    model's latents: norm ~6.5, spread ~0.1) keep their labels: ``predict``
    measures distances from the fit's mean, so a common offset of 1e3 on
    clusters 1e-3 apart changes nothing, where the raw |c|^2 - 2 x.c in
    float32 (scikit-learn's) would round the margins away."""
    X = torch.tensor(_blobs()) * 1e-3
    km = KMeans(4, generator=torch.Generator().manual_seed(1)).fit(X)
    assert torch.equal(km.predict(X), km.labels_)
    far = KMeans(4, generator=torch.Generator().manual_seed(1)).fit(X + 1e3)
    assert torch.equal(far.labels_, km.labels_)
    assert torch.equal(far.predict(X + 1e3), km.labels_)


def test_kmeans_gives_an_empty_cluster_the_farthest_row():
    """A centre that no row is nearest to takes the row farthest from its
    own centre, as scikit-learn's relocation does."""
    X = np.array([[0.0], [0.1], [0.2], [10.0]], np.float32)
    init = np.array([[0.1], [100.0], [10.0]], np.float32)
    ours = KMeans(3, init=torch.tensor(init)).fit(torch.tensor(X))
    ref = _sklearn_kmeans(X, init)
    np.testing.assert_array_equal(ours.labels_.numpy(), ref.labels_)
    np.testing.assert_allclose(ours.cluster_centers_.numpy(), ref.cluster_centers_,
                               atol=1e-6)


def test_clustering_accuracy_matches_jax_from_the_same_centres(world):
    """Both evaluators fit their k-means from the same initial centres on
    the same shuffled train rows (posterior means), label each cluster by
    its majority class and score the test rows, in 2 runs."""
    from sklearn.cluster import KMeans as SKMeans

    jmodel, tmodel = world["models"]["mvtcae"]
    with torch.no_grad():
        z = tmodel.encode(MultimodalBaseDataset(world["train"]), return_mean=True).z
    init = kmeans_plusplus(z, N_CLASSES, torch.Generator().manual_seed(2))
    cfg = dict(n_clusters=N_CLASSES, number_of_runs=2)

    def build_j(model):
        ev = JClustering(model, _datasets(world, False),
                         JDataset(world["train"], labels=world["train_labels"]),
                         eval_config=JClusteringConfig(**cfg, **J_COMMON))
        ev.clustering = SKMeans(n_clusters=N_CLASSES, init=init.numpy(), n_init=1,
                                max_iter=300)
        return ev.eval

    def build_t(model):
        ev = Clustering(model, _datasets(world, True),
                        MultimodalBaseDataset(world["train"], labels=world["train_labels"]),
                        eval_config=ClusteringConfig(batch_size=BATCH, **cfg))
        ev.clustering = KMeans(N_CLASSES, init=init)
        return ev.eval

    ref, out = _run(world, "mvtcae", build_j, build_t)
    assert out.cluster_accuracy == ref.cluster_accuracy
    assert 0 < out.cluster_accuracy <= 1


# ---------------------------------------------------------- visualization
def _near_rounding(grid):
    """Pixels whose float value lies within 1e-4 of a rounding boundary."""
    scaled = np.asarray(grid) * 255.0 + 0.5
    return np.transpose(np.abs(scaled - np.round(scaled)) < 1e-4 * 255, (1, 2, 0))


@pytest.mark.parametrize("family", ["mvtcae", "mmvae"])
def test_visualization_matches_jax_pixels_and_png(world, family, tmp_path, monkeypatch):
    """Unconditional and conditional grids: the port's uint8 pixels are
    the JAX package's PIL image's, but where the float value lies within
    1e-4 of a rounding boundary (where they may differ by one level); the
    PNG the port writes reads back as those pixels."""
    from PIL import Image

    grids = []

    def recording_grid_to_pil(grid):
        grids.append(np.asarray(grid))
        return grid_to_pil(grid)

    monkeypatch.setattr(jvis, "grid_to_pil", recording_grid_to_pil)
    cfg = dict(n_samples=3, n_data_cond=4)

    def calls(ev):
        return lambda: [ev.unconditional_samples(), ev.conditional_samples_subset(["m1"]),
                        ev.reconstruction("m0")]

    def build_j(model):
        return calls(JVisualization(model, _datasets(world, False),
                                    eval_config=JVisualizationConfig(**cfg, **J_COMMON)))

    def build_t(model):
        return calls(Visualization(model, _datasets(world, True), output=str(tmp_path),
                                   eval_config=VisualizationConfig(**cfg)))

    ref, out = _run(world, family, build_j, build_t)
    for ours, image, grid in zip(out, ref, grids):
        jpix = np.asarray(image)
        assert ours.dtype == np.uint8 and ours.shape == jpix.shape
        diff = np.abs(ours.astype(int) - jpix.astype(int))
        assert diff.max() <= 1 and not diff[~_near_rounding(grid)].any()
    written = {
        "unconditional.png": out[0],
        "conditional_from_subset_['m1'].png": out[1],
        "conditional_from_subset_['m0'].png": out[2],
    }
    for name, pixels in written.items():
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), pixels)


def test_grid_helpers_match_jax():
    rng = np.random.default_rng(3)
    data = {"a": rng.uniform(size=(5, 8)), "b": rng.uniform(size=(5, 2, 6, 7)),
            "c": rng.uniform(size=(5, 1, 9, 9)), "d": rng.uniform(size=(5, 4, 3, 3))}
    ours, shape = adapt_shape(data)
    ref, ref_shape = j_adapt_shape(data)
    assert shape == ref_shape == (3, 9, 9)
    for m in data:
        np.testing.assert_array_equal(ours[m], ref[m])
    images = np.concatenate(list(ours.values()))
    grid = make_grid(images, nrow=6, padding=1, pad_value=0.5)
    np.testing.assert_array_equal(grid, j_make_grid(images, nrow=6, padding=1, pad_value=0.5))
    np.testing.assert_array_equal(grid_to_image(grid * 1.2 - 0.1),
                                  np.asarray(grid_to_pil(grid * 1.2 - 0.1)))
    with pytest.raises(AttributeError):
        adapt_shape({"x": np.zeros((2, 1, 2, 2, 2))})


# ------------------------------------------------------------ classifier
def test_classifier_matches_jax_through_its_converter():
    """The port's module, random weights, against the JAX package's Flax
    classifier on those weights (``convert_torch_classifier_state_dict``),
    and back (``classifier_from_jax``). Two convs and two dense layers:
    float32 sums of a few hundred terms."""
    clf = ClassifierPolyMNIST().reset_parameters(torch.Generator().manual_seed(4))
    state = {k: v.numpy() for k, v in clf.state_dict().items()}
    params = convert_torch_classifier_state_dict(state)
    x = np.random.default_rng(4).uniform(size=(5, 3, 28, 28)).astype(np.float32)
    ref = np.asarray(JClassifier().apply({"params": params}, x))
    with torch.no_grad():
        ours = clf(torch.tensor(x)).numpy()
        feats = clf.features(torch.tensor(x))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    assert feats.shape == (5, 128) and (feats >= 0).all()
    back = classifier_from_jax({"params": params})
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k])


def test_load_mmnist_classifiers_reads_torch_state_dicts(tmp_path):
    from multivae_tpu_torch.metrics import load_mmnist_classifiers

    with pytest.raises(FileNotFoundError, match="m0"):
        load_mmnist_classifiers(str(tmp_path), device="cpu")
    clfs = [ClassifierPolyMNIST().reset_parameters(torch.Generator().manual_seed(i))
            for i in range(5)]
    for i, c in enumerate(clfs):
        torch.save(c.state_dict(), tmp_path / f"pretrained_img_to_digit_clf_m{i}")
    loaded = load_mmnist_classifiers(str(tmp_path), device="cpu")
    x = torch.rand(2, 3, 28, 28)
    assert list(loaded) == [f"m{i}" for i in range(5)]
    for i, c in enumerate(clfs):
        assert not loaded[f"m{i}"].training
        assert torch.equal(loaded[f"m{i}"](x), c(x))


# ---------------------------------------------------------- data helpers
def test_random_split_and_resample_dataset_match_jax():
    from multivae_tpu.data.datasets.base import random_split as j_random_split

    rng = np.random.default_rng(5)
    data = {"a": rng.normal(size=(23, 3)), "b": rng.normal(size=(23, 2, 2))}
    labels = np.arange(23)
    ours = random_split(MultimodalBaseDataset(data, labels=labels), [0.9, 0.1], seed=7)
    ref = j_random_split(JDataset(data, labels=labels), [0.9, 0.1], seed=7)
    assert [len(d) for d in ours] == [len(d) for d in ref] == [21, 2]
    for o, r in zip(ours, ref):
        assert isinstance(o, ResampleDataset)
        np.testing.assert_array_equal(o.indices, r.indices)
        np.testing.assert_array_equal(o.labels, r.labels)
        idx = np.arange(len(o))[::-1]
        for m in data:
            np.testing.assert_array_equal(o.get_batch(idx)["data"][m],
                                          r.get_batch(idx)["data"][m])
    assert ours[0].transform_for_plotting("x", "a") == "x"
    with pytest.raises(ValueError, match="sum to 1"):
        random_split(MultimodalBaseDataset(data), [0.5, 0.6])
    view = ResampleDataset(MultimodalBaseDataset(data))
    assert len(view) == 23 and view.labels is None


def test_subset_order_matches_jax():
    mods = ["m0", "m1", "m2", "m3"]
    assert all_subsets(mods) == j_all_subsets(mods)
    assert all_subsets(mods, 2, 3) == j_all_subsets(mods, 2, 3)


def test_evaluator_logs_to_its_folder_and_refuses_an_unfitted_sampler(world, tmp_path):
    _, tmodel = world["models"]["mvtcae"]
    ev = Reconstruction(tmodel, _datasets(world, True), output=str(tmp_path / "out"),
                        eval_config=ReconstructionConfig(batch_size=BATCH, metric="MSE"),
                        generator=torch.Generator().manual_seed(0))
    ev.eval()
    ev.finish()
    with open(os.path.join(tmp_path, "out", "metrics.log")) as f:
        assert "reconstruction" in f.read()
    with pytest.raises(AttributeError, match="not fitted"):
        Visualization(tmodel, _datasets(world, True), sampler=GaussianMixtureSampler(tmodel))
    with pytest.raises(ValueError, match="metric"):
        ReconstructionConfig(metric="PSNR")
