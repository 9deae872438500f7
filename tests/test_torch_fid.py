"""The port's FID pieces against the JAX package's, on the CPU at a small
size: the InceptionV3 of the FID at 75x75 (its smallest input) on random
weights, the shape adapter's resize both ways, the Fréchet distance, and
the ``FIDEvaluator`` (unconditional and every conditional FID) of an MLP
``MVTCAE`` of 3 modalities with a custom embedder, 30 rows in batches of
12 (the last one padded).

The evaluators' draws are the JAX model's keys in call order, fed to the
port through ``torch_parity.JaxCallDraws``. Tolerances are stated where
they are used.
"""

import logging
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.metrics import FIDEvaluator as JFIDEvaluator
from multivae_tpu.metrics import FIDEvaluatorConfig as JFIDEvaluatorConfig
from multivae_tpu.metrics.fids import AdaptShapeFID as JAdaptShapeFID
from multivae_tpu.metrics.fids.inception_networks import InceptionV3FID as JInception
from multivae_tpu.metrics.fids.inception_networks import convert_torch_state_dict
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu_torch.data import MultimodalBaseDataset
from multivae_tpu_torch.metrics import (
    AdaptShapeFID,
    FIDEvaluator,
    FIDEvaluatorConfig,
    InceptionV3FID,
)
from multivae_tpu_torch.metrics.fids import wrapper_inception
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.utils.convert import inception_from_jax
from torch_parity import JaxCallDraws, port_model, record_keys

torch.set_num_threads(2)

DIMS = {"m0": (1, 8, 8), "m1": (5,), "m2": (3, 4, 4)}
LATENT, N_ROWS, BATCH, EMB = 4, 30, 12, 3
# Fréchet distances: means and covariances of float32 embeddings, then a
# float64 square root; the embeddings differ in the last float32 bits.
FD_TOL = dict(rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- Inception
def test_inception_matches_jax_through_its_converter():
    """Random weights (He-normal convs, identity BatchNorms) through the
    JAX package's ``convert_torch_state_dict`` into its Flax InceptionV3,
    on 2 images of 75x75; and back through ``inception_from_jax``. 94
    float32 conv layers: compared normwise, the largest difference within
    2e-5 of the largest embedding."""
    net = InceptionV3FID().reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = convert_torch_state_dict(state)
    x = np.random.default_rng(0).uniform(size=(2, 3, 75, 75)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: JInception().apply(v, x)["embedding"])(
        variables, x))
    with torch.no_grad():
        ours = net(torch.tensor(x)).embedding.numpy()
    assert ours.shape == ref.shape == (2, 2048)
    assert np.abs(ours - ref).max() <= 2e-5 * np.abs(ref).max()
    back = inception_from_jax(variables)
    assert set(back) == set(state)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), state[k], err_msg=k)


def test_wrapper_inception_loads_a_pytorch_fid_state_dict(models, tmp_path):
    """A pytorch-fid ``state_dict`` (with its ``fc`` head) loads into the
    port's network; a missing file raises as in the JAX package."""
    with pytest.raises(FileNotFoundError, match="InceptionV3"):
        wrapper_inception(path_weights=str(tmp_path / "missing.pth"), device="cpu")
    net = InceptionV3FID().reset_parameters(torch.Generator().manual_seed(1))
    state = dict(net.state_dict(), **{"fc.weight": torch.zeros(1008, 2048),
                                      "fc.bias": torch.zeros(1008)})
    path = tmp_path / "pt_inception.pth"
    torch.save(state, path)
    loaded = wrapper_inception(path_weights=str(path), device="cpu")
    assert not loaded.training
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(ValueError, match="2048"):
        wrapper_inception(dims=768, path_weights=str(path), device="cpu")
    fid = FIDEvaluator(models[1], MultimodalBaseDataset(_data()[0]),
                       eval_config=FIDEvaluatorConfig(inception_weights_path=str(path)))
    assert isinstance(fid.inception_transform, AdaptShapeFID)
    assert len({id(e) for e in fid.model_fds.values()}) == 1


@pytest.mark.parametrize("shape", [(3, 1, 28, 28), (2, 3, 320, 300), (2, 2, 16, 20),
                                   (2, 5, 9, 9), (2, 10, 12), (4, 6)])
def test_adapt_shape_fid_matches_jax(shape):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks:
    the port's ``F.interpolate(..., antialias=True)`` gives the same pixels
    up (28 -> 299) within 1e-6 and down (320 -> 299) within 2e-5: the
    antialiased shrink sums a few float32 taps a pixel, with filter weights
    each library rounds its own way."""
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    ours = AdaptShapeFID()(torch.tensor(x)).numpy()
    ref = np.asarray(JAdaptShapeFID()(x))
    assert ours.shape == ref.shape == (shape[0], 3, 299, 299)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=2e-5 if shape[-2] > 299 else 1e-6)
    kept = AdaptShapeFID(resize=False)(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(kept, np.asarray(JAdaptShapeFID(resize=False)(x)))


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(50, 6)), rng.normal(loc=0.3, size=(50, 6)) @ rng.normal(
        size=(6, 6))
    stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    fid = FIDEvaluator.__new__(FIDEvaluator)
    jfid = JFIDEvaluator.__new__(JFIDEvaluator)
    fid.logger = jfid.logger = logging.getLogger(__name__)
    ours = fid.calculate_frechet_distance(*stats)
    assert ours > 0
    np.testing.assert_allclose(ours, jfid.calculate_frechet_distance(*stats), rtol=1e-12)
    # a singular product: the retry with eps on the diagonals
    sing = (a.mean(0), np.zeros((6, 6)), b.mean(0), np.cov(b, rowvar=False))
    np.testing.assert_allclose(fid.calculate_frechet_distance(*sing),
                               jfid.calculate_frechet_distance(*sing), rtol=1e-12)
    with pytest.raises(ValueError, match="shapes"):
        fid.calculate_frechet_distance(a.mean(0), stats[1], b.mean(0)[:3], stats[3])


# ------------------------------------------------------------ evaluator
def _data():
    rng = np.random.default_rng(3)
    data = {m: rng.uniform(size=(N_ROWS, *d)).astype(np.float32) for m, d in DIMS.items()}
    weights = {m: rng.normal(size=(math.prod(d), EMB)).astype(np.float32)
               for m, d in DIMS.items()}
    return data, weights


def _pair():
    cfg = dict(n_modalities=3, latent_dim=LATENT, input_dims=DIMS)
    jmodel = JMVTCAE(JMVTCAEConfig(**cfg), seed=2)
    return jmodel, port_model(jmodel, MVTCAE(MVTCAEConfig(**cfg), device="cpu"))


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.mark.parametrize("call", ["unconditional", "conditional"])
def test_fid_evaluator_matches_jax(models, call, tmp_path):
    """``eval`` (each modality's FID from the prior) and
    ``compute_all_conditional_fids("m0")`` (from m1, m2 and both, with the
    means by subset size), with a linear embedder of 3 features and the
    default transform (none) for custom embedders."""
    jmodel, tmodel = models
    data, weights = _data()
    jenc = {m: (lambda x, w=w: jnp.asarray(x).reshape(len(x), -1) @ w)
            for m, w in weights.items()}
    tenc = {m: (lambda x, w=torch.tensor(w): x.flatten(1) @ w) for m, w in weights.items()}
    jmodel.set_seed(5)
    keys = record_keys(jmodel)
    try:
        jfid = JFIDEvaluator(jmodel, JDataset(data), custom_encoders=jenc,
                             eval_config=JFIDEvaluatorConfig(
                                 batch_size=BATCH, fused_sweep=False, cache_on_device=False))
        ref = jfid.eval() if call == "unconditional" else jfid.compute_all_conditional_fids(
            "m0")
    finally:
        del jmodel.next_rng
    feed = JaxCallDraws(tmodel, keys)
    try:
        fid = FIDEvaluator(tmodel, MultimodalBaseDataset(data), custom_encoders=tenc,
                           output=str(tmp_path),
                           eval_config=FIDEvaluatorConfig(batch_size=BATCH))
        out = (fid.eval() if call == "unconditional"
               else fid.compute_all_conditional_fids("m0"))
        fid.finish()
    finally:
        for name in (*JaxCallDraws.CALLS, "draw_noise"):
            tmodel.__dict__.pop(name, None)
    assert not feed.keys and fid.inception_transform is None
    expected = ({f"fd_{m}_sampler_prior" for m in DIMS} if call == "unconditional" else {
        "Conditional FD from m1 to m0", "Conditional FD from m2 to m0",
        "Conditional FD from m1_m2 to m0", "Mean FD from 1 modalities to m0",
        "Mean FD from 2 modalities to m0"})
    assert set(out) == set(ref) == expected
    for k in ref:
        assert np.isfinite(out[k]) and out[k] > 0
        np.testing.assert_allclose(out[k], ref[k], err_msg=k, **FD_TOL)
    assert os.path.exists(tmp_path / "metrics.log")
