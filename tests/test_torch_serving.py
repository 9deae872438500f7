"""The port's serving endpoints (``multivae_tpu_torch/serving.py``) against
the JAX package's, on the CPU at a small size: MVTCAE, MMVAE and DMVAE on
their default MLP nets (3 modalities: two vectors and a 1x3x3 image,
latent 4), at a fixed batch of 8.

Compared on posterior means (``deterministic=True``, no draws): a
``Predictor``'s reply to a request of 5 rows, padded to 8 and cut back,
and an ``AnySubsetPredictor``'s reply to rows that each bring another
subset of the modalities, elementwise within float32 noise of the
decoders' outputs (1e-5); every request check with the JAX message; the
refusal of a mixture model; the endpoint's generator advancing from call
to call.
"""

import numpy as np
import pytest
import torch

from multivae_tpu import serving as jserving
from multivae_tpu.models import DMVAE as JDMVAE
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import DMVAEConfig as JDMVAEConfig
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu_torch import models, serving
from torch_parity import port_model

torch.set_num_threads(2)

DIMS = {"m0": (5,), "m1": (6,), "m2": (1, 3, 3)}
BATCH, ROWS = 8, 5
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
JAX = {"MVTCAE": (JMVTCAE, JMVTCAEConfig), "MMVAE": (JMMVAE, JMMVAEConfig),
       "DMVAE": (JDMVAE, JDMVAEConfig)}
EXTRA = {"MVTCAE": {}, "MMVAE": dict(K=2),
         "DMVAE": dict(modalities_specific_dim={"m0": 1, "m1": 2, "m2": 2})}


def _models(name):
    cfg = dict(n_modalities=3, latent_dim=4, input_dims=DIMS, **EXTRA[name])
    jcls, jconfig = JAX[name]
    jmodel = jcls(jconfig(**cfg), seed=0)
    tmodel = getattr(models, name)(getattr(models, name + "Config")(**cfg), device="cpu")
    return jmodel, port_model(jmodel, tmodel)


@pytest.fixture(scope="module")
def pairs():
    return {name: _models(name) for name in JAX}


def _request(seed, n=ROWS):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


def _assert_same(out, ref, n=ROWS):
    assert set(out) == set(ref) == set(DIMS)
    for m, d in DIMS.items():
        assert isinstance(out[m], np.ndarray) and out[m].shape == (n, *d) == ref[m].shape, m
        np.testing.assert_allclose(out[m], np.asarray(ref[m]), err_msg=m, **VALUE_TOL)


@pytest.mark.parametrize("name, cond", [("MVTCAE", ["m0", "m2"]), ("MMVAE", ["m1"])])
def test_predictor_matches_jax(pairs, name, cond):
    jmodel, tmodel = pairs[name]
    request = {m: v for m, v in _request(1).items() if m in cond}
    ref = jserving.Predictor(jmodel, cond_mod=cond, batch_size=BATCH,
                             deterministic=True).warmup()(request)
    pred = serving.Predictor(tmodel, cond_mod=cond, batch_size=BATCH, deterministic=True)
    assert pred.cond_mod == tuple(cond) and pred.gen_mod == tuple(DIMS)
    _assert_same(pred.warmup()(request), ref)
    # a padding row does not reach the rows before it
    _assert_same(pred({m: v[:2] for m, v in request.items()}), {
        m: np.asarray(v)[:2] for m, v in ref.items()}, n=2)


def test_sampled_replies_advance_and_repeat_with_the_seed(pairs):
    """Without ``deterministic`` each call draws anew from the endpoint's
    generator; a new endpoint with the same seed repeats the first call."""
    _, tmodel = pairs["MVTCAE"]
    request = {"m0": _request(2)["m0"]}
    pred = serving.Predictor(tmodel, cond_mod="m0", batch_size=BATCH, seed=3)
    first, second = pred(request), pred(request)
    assert any(not np.array_equal(first[m], second[m]) for m in DIMS)
    again = serving.Predictor(tmodel, cond_mod="m0", batch_size=BATCH, seed=3)(request)
    for m in DIMS:
        assert np.array_equal(again[m], first[m]), m
    assert pred.generator.device == tmodel.device == torch.device("cpu")


def _mixed(seed):
    """Rows bringing every nonempty subset of the three modalities in turn
    (the first row all three), and the data of an absent modality left in."""
    data = _request(seed)
    pattern = [7, 1, 2, 4, 5]   # bits: m0, m1, m2
    masks = {m: np.asarray([(p >> i) & 1 for p in pattern], np.float32)
             for i, m in enumerate(DIMS)}
    return data, masks


@pytest.mark.parametrize("name", ["MVTCAE", "DMVAE"])
def test_any_subset_predictor_matches_jax(pairs, name):
    jmodel, tmodel = pairs[name]
    data, masks = _mixed(4)
    ref = jserving.AnySubsetPredictor(jmodel, batch_size=BATCH,
                                      deterministic=True).warmup()(data, masks)
    pred = serving.AnySubsetPredictor(tmodel, batch_size=BATCH, deterministic=True)
    _assert_same(pred.warmup()(data, masks), ref)
    # a modality left out of the request counts as absent on every row
    partial = {m: v for m, v in data.items() if m != "m1"}
    pmasks = {m: v for m, v in masks.items() if m != "m1"}
    pmasks["m0"] = np.ones(ROWS, np.float32)
    _assert_same(pred(partial, pmasks), jserving.AnySubsetPredictor(
        jmodel, batch_size=BATCH, deterministic=True)(partial, pmasks))


def test_any_subset_predictor_refuses_mixture_models(pairs):
    jmodel, tmodel = pairs["MMVAE"]
    with pytest.raises(TypeError) as jerr:
        jserving.AnySubsetPredictor(jmodel)
    with pytest.raises(TypeError) as err:
        serving.AnySubsetPredictor(tmodel)
    assert str(err.value) == str(jerr.value)


REQUEST_ERRORS = {
    "empty": ("predictor", lambda d: ({},)),
    "uneven_rows": ("predictor", lambda d: ({"m0": d["m0"], "m2": d["m2"][:3]},)),
    "missing_modality": ("predictor", lambda d: ({"m0": d["m0"]},)),
    "too_many_rows": ("predictor", lambda d: ({m: np.concatenate([v, v]) for m, v in
                                               d.items()},)),
    "unknown_modality": ("any", lambda d: ({"m0": d["m0"], "x": d["m0"]},)),
    "orphan_mask": ("any", lambda d: ({"m0": d["m0"]}, {"m1": np.ones(ROWS)})),
    "mask_rows": ("any", lambda d: ({"m0": d["m0"]}, {"m0": np.ones(ROWS - 1)})),
    "row_without_modality": ("any", lambda d: ({"m0": d["m0"]}, {
        "m0": np.asarray([1, 0, 1, 1, 1], np.float32)})),
    "any_too_many_rows": ("any", lambda d: ({"m0": np.concatenate([d["m0"], d["m0"]])},)),
}


@pytest.mark.parametrize("case", list(REQUEST_ERRORS))
def test_request_errors_match_jax(pairs, case):
    kind, args = REQUEST_ERRORS[case]
    jmodel, tmodel = pairs["MVTCAE"]
    args = args(_request(5))
    if kind == "predictor":
        endpoints = (jserving.Predictor(jmodel, cond_mod=["m0", "m2"], batch_size=BATCH),
                     serving.Predictor(tmodel, cond_mod=["m0", "m2"], batch_size=BATCH))
    else:
        endpoints = (jserving.AnySubsetPredictor(jmodel, batch_size=BATCH),
                     serving.AnySubsetPredictor(tmodel, batch_size=BATCH))
    messages = []
    for endpoint in endpoints:
        with pytest.raises(ValueError) as err:
            endpoint(*args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
