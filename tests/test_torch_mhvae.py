"""The port's MHVAE against the JAX package's, on the CPU at a small size.

Two block families over 2 modalities (3 subsets; the JAX side's compiles
grow with the subsets), n_latent 3:

- ``mlp``: the MLP blocks of ``tests/mhvae_test_architectures.py`` (hidden
  16, latent 4) and their torch copies below, on vector modalities;
- ``conv``: narrow copies of ``examples/mhvae_polymnist.py``'s nets (c1 4,
  c2 8, c3 8, hidden 16, latent 6) on 3x28x28 images, kept below in Flax
  (the example trains when it is imported) and taken from
  ``multivae_tpu_torch/tools/mhvae_nets.py`` on the port's side.

Weights cross with ``params_from_jax``; noise is the JAX package's
``jax.random.normal`` of each subset's and level's key (a conv level's
(B, H, W, C) draw permuted to NCHW), stacked over the subsets as the port
draws a level once for all of them. Compared: each conv net alone (Flax's asymmetric
'SAME' padding and its NHWC flatten order), the loss, ``loss_sum``, the
metrics (the last subset's KLs) and every gradient with shared and unshared
posteriors on complete and incomplete batches; encode (N 1 and 3, flatten
or not, the mean) and predict after the NHWC -> NCHW permute; the per-row
encode of an incomplete batch against the JAX ``_encode_masked``; the
checks' errors; save and reload; and a 3-epoch ``BaseTrainer`` curve
against the JAX trainer, with the kept weights.
"""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhvae_test_architectures import build_mhvae_blocks
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MHVAE as JMHVAE
from multivae_tpu.models import MHVAEConfig as JMHVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.utils.model_output import ModelOutput as JOutput
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import MHVAE, MHVAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.tools import mhvae_nets
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import (
    Recorder,
    assert_same_moves,
    feed_trainer_noise,
    mhvae_mlp_blocks,
    normal,
    state_of,
)

torch.set_num_threads(2)

MODS = ("m0", "m1")
MLP_DIMS = {"m0": (4,), "m1": (6,)}
CONV_DIMS = {m: (3, 28, 28) for m in MODS}
MLP_LATENT, CONV_LATENT = 4, 6
C1, C2, C3, HIDDEN = 4, 8, 8, 16
B, SEED = 6, 3
# Losses and KLs: sums of 10^2-10^4 float32 terms in another order (and,
# for the convs, other conv algorithms): 1e-5 relative. Gradients: such
# sums through 3 levels and 3 subsets of products of experts: 1e-4
# relative, with an absolute floor of 1e-5 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Latents and decoder outputs, elementwise after the same draws.
VALUE_TOL = dict(rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- the example's nets
# Narrow Flax copies of ``examples/mhvae_polymnist.py:34-100`` (the widths as
# fields; the layers, activations and paddings as there).
class JInputEncoder(fnn.Module):
    width: int = C1

    @fnn.compact
    def __call__(self, x):
        x = jnp.transpose(x, (0, 2, 3, 1))
        h = fnn.silu(fnn.Conv(self.width, (3, 3))(x))
        return JOutput(embedding=fnn.silu(fnn.Conv(self.width, (3, 3), strides=2)(h)))


class JBottomUpMid(fnn.Module):
    width: int = C2

    @fnn.compact
    def __call__(self, h):
        return fnn.silu(fnn.Conv(self.width, (3, 3), strides=2)(h))


class JBottomUpLast(fnn.Module):
    width: int = C3
    hidden: int = HIDDEN
    latent: int = CONV_LATENT

    @fnn.compact
    def __call__(self, h):
        h = fnn.silu(fnn.Conv(self.width, (3, 3), strides=2)(h))
        h = fnn.silu(fnn.Dense(self.hidden)(h.reshape(h.shape[0], -1)))
        return JOutput(embedding=fnn.Dense(self.latent)(h),
                       log_covariance=fnn.Dense(self.latent)(h))


class JTopDown2(fnn.Module):
    hidden: int = HIDDEN
    width: int = C2

    @fnn.compact
    def __call__(self, z):
        h = fnn.silu(fnn.Dense(self.hidden)(z))
        h = fnn.silu(fnn.Dense(7 * 7 * self.width)(h))
        return h.reshape(z.shape[0], 7, 7, self.width)


class JTopDown1(fnn.Module):
    width: int = C1

    @fnn.compact
    def __call__(self, z):
        return fnn.silu(fnn.ConvTranspose(self.width, (3, 3), strides=(2, 2))(z))


class JConvHead(fnn.Module):
    channels: int

    @fnn.compact
    def __call__(self, h):
        h = fnn.silu(fnn.Conv(self.channels, (3, 3))(h))
        return JOutput(embedding=fnn.Conv(self.channels, (1, 1))(h),
                       log_covariance=fnn.Conv(self.channels, (1, 1))(h))


class JOutputDecoder(fnn.Module):
    width: int = C1

    @fnn.compact
    def __call__(self, z):
        h = fnn.silu(fnn.ConvTranspose(self.width, (3, 3), strides=(2, 2))(z))
        return JOutput(reconstruction=jnp.transpose(fnn.Conv(3, (3, 3))(h), (0, 3, 1, 2)))


def _jax_conv_blocks(shared):
    post = lambda: [JConvHead(C1), JConvHead(C2)]    # noqa: E731
    return ({m: JInputEncoder() for m in MODS}, {m: JOutputDecoder() for m in MODS},
            {m: [JBottomUpMid(), JBottomUpLast()] for m in MODS},
            [JTopDown1(), JTopDown2()],
            post() if shared else {m: post() for m in MODS},
            [JConvHead(C1), JConvHead(C2)])


def _port_conv_blocks(shared):
    return mhvae_nets.build_blocks(MODS, C1, C2, C3, HIDDEN, CONV_LATENT,
                                   shared_posteriors=shared)


def _port_mlp_blocks(shared):
    return mhvae_mlp_blocks(MLP_DIMS, MLP_LATENT, shared)


# ------------------------------------------------------------------ models
def _config_kwargs(kind):
    dims = MLP_DIMS if kind == "mlp" else CONV_DIMS
    dists = ({"m0": "normal", "m1": "laplace"} if kind == "mlp"
             else {m: "laplace" for m in dims})
    return dict(n_modalities=len(dims),
                latent_dim=MLP_LATENT if kind == "mlp" else CONV_LATENT,
                input_dims=dims, n_latent=3, beta=1.5, decoders_dist=dists,
                decoder_dist_params={m: {"scale": 0.75} for m in dims})


def _block_kwargs(blocks):
    names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
             "posterior_blocks", "prior_blocks")
    return dict(zip(names, blocks))


def _arrays(kind, incomplete, seed=0, n=B):
    dims = MLP_DIMS if kind == "mlp" else CONV_DIMS
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in dims.items()}
    if not incomplete:
        return data, None, None
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in dims}
    for m in dims:
        masks[m][0] = 1.0        # a complete row
        masks[m][1] = 0.0        # a row with no modality
    masks["m0"][2], masks["m1"][2] = 0.0, 1.0
    for m in dims:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0            # a loader padding row
    return data, masks, weights


def _jax_models(kind):
    """The JAX models of ``kind`` with shared and with unshared posteriors,
    their inits (each on its own next key, as ``init_params_with_batch``
    draws it) compiled as one function: run op by op, a conv model's first
    init takes 20 s."""
    models = {}
    for shared in (True, False):
        blocks = (build_mhvae_blocks(MLP_DIMS, n_latent=3, latent_dim=MLP_LATENT,
                                     shared_posteriors=shared)
                  if kind == "mlp" else _jax_conv_blocks(shared))
        models[shared] = JMHVAE(JMHVAEConfig(**_config_kwargs(kind)), **_block_kwargs(blocks),
                                seed=0)
    data, _, _ = _arrays(kind, False)
    keys = {shared: jmodel.next_rng() for shared, jmodel in models.items()}
    params = jax.jit(lambda batch, keys: {
        shared: jmodel.init_params_with_batch(batch, keys[shared])
        for shared, jmodel in models.items()})(j_batch_from_arrays(data=data), keys)
    for shared, jmodel in models.items():
        jmodel.params = params[shared]
    return models


def _port(jmodel, kind, shared):
    blocks = _port_mlp_blocks(shared) if kind == "mlp" else _port_conv_blocks(shared)
    tmodel = MHVAE(MHVAEConfig(**_config_kwargs(kind)), **_block_kwargs(blocks),
                   device="cpu")
    tmodel.load_state_dict(state_of(jmodel.params))
    return tmodel


@pytest.fixture(scope="module")
def jax_models():
    cache = {}

    def get(kind, shared):
        if kind not in cache:
            cache[kind] = _jax_models(kind)
        return cache[kind][shared]
    return get


def _level_keys(key, n_levels=3):
    """The keys of one JAX ``subset_encode`` call on ``key``, deepest level
    first: each level splits ``rng, z_rng = split(rng)``."""
    keys = []
    for _ in range(n_levels):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def _jax_normal(key, shape):
    """``jax.random.normal(key, ...)`` at a port shape: a shape of 4 axes is
    an NCHW map, whose JAX draw is NHWC."""
    if len(shape) == 4:
        n, c, h, w = shape
        return normal(key, (n, h, w, c)).permute(0, 3, 1, 2).contiguous()
    return normal(key, shape)


def _level_noise(key):
    """The ``draw_noise`` hook of one encode on ``key``: a draw a level."""
    keys = iter(_level_keys(key))
    return lambda shape, generator=None: _jax_normal(next(keys), tuple(shape))


def _loss_noise(key, n_subsets):
    """``loss_function``: ``rng, _ = split(key)`` and one key per subset
    from ``split(rng, n_subsets)``, each subset's levels chained from its
    key. The port draws each level once for all subsets, the subsets' rows
    in blocks: the JAX subsets' draws of that level, stacked."""
    rng, _ = jax.random.split(key)
    chains = [_level_keys(k) for k in jax.random.split(rng, n_subsets)]
    levels = iter(range(3))

    def noise(shape, generator=None):
        level, rows = next(levels), shape[0] // n_subsets
        return torch.cat([_jax_normal(keys[level], (rows, *shape[1:])) for keys in chains])
    return noise


def _nchw(x):
    x = np.asarray(x)
    return torch.tensor(np.moveaxis(x, -1, -3) if x.ndim >= 4 else x)


# ------------------------------------------------------------------- tests
NET_CASES = {
    "InputEncoder": (JInputEncoder(), lambda: mhvae_nets.InputEncoder(C1), (2, 3, 28, 28)),
    "BottomUpMid": (JBottomUpMid(), lambda: mhvae_nets.BottomUpMid(C1, C2), (2, 14, 14, C1)),
    "BottomUpLast": (JBottomUpLast(), lambda: mhvae_nets.BottomUpLast(C2, C3, HIDDEN,
                                                                      CONV_LATENT),
                     (2, 7, 7, C2)),
    "TopDown2": (JTopDown2(), lambda: mhvae_nets.TopDown2(CONV_LATENT, HIDDEN, C2),
                 (2, CONV_LATENT)),
    "TopDown1": (JTopDown1(), lambda: mhvae_nets.TopDown1(C2, C1), (2, 7, 7, C2)),
    "ConvHead": (JConvHead(C2), lambda: mhvae_nets.ConvHead(2 * C2, C2), (2, 7, 7, 2 * C2)),
    "OutputDecoder": (JOutputDecoder(), lambda: mhvae_nets.OutputDecoder(C1, C1),
                      (2, 14, 14, C1)),
}


@pytest.mark.parametrize("name", list(NET_CASES))
def test_example_nets_match_flax(name):
    """Each net on the same input and weights: Flax's asymmetric 'SAME'
    padding of the stride-2 convs (28 -> 14 -> 7 pad (0, 1), 7 -> 4 pads
    (1, 1)), its (2, 1) transposed convs, and the (h, w, c) order of
    ``BottomUpLast``'s flatten and ``TopDown2``'s unflatten."""
    jnet, make, shape = NET_CASES[name]
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params = jax.jit(jnet.init)(jax.random.key(2), x)["params"]
    ref = jax.jit(jnet.apply)({"params": params}, x)
    net = make()
    state = params_from_jax({"decoders": {"net": jax.tree.map(np.asarray, params)}})
    net.load_state_dict({k[len("decoders.net."):]: v for k, v in state.items()})
    xt = torch.tensor(x) if name in ("InputEncoder", "TopDown2") else _nchw(x)
    with torch.no_grad():
        out = net(xt)
    refs = ref if isinstance(ref, dict) else {"out": ref}
    outs = out if isinstance(out, dict) else {"out": out}
    assert set(outs) == set(refs)
    for k, v in refs.items():
        want = np.asarray(v) if name == "OutputDecoder" else _nchw(v).numpy()
        assert outs[k].shape == want.shape, (k, outs[k].shape, want.shape)
        np.testing.assert_allclose(outs[k].numpy(), want, err_msg=k, **VALUE_TOL)


LOSS_CASES = [("mlp", True, False), ("mlp", False, True), ("conv", True, True),
              ("conv", False, False)]


@pytest.mark.parametrize("kind,shared,incomplete", LOSS_CASES,
                         ids=["mlp-shared-complete", "mlp-unshared-masked",
                              "conv-shared-masked", "conv-unshared-complete"])
def test_loss_metrics_and_every_gradient_match_jax(jax_models, kind, shared, incomplete):
    jmodel = jax_models(kind, shared)
    tmodel = _port(jmodel, kind, shared)
    assert tmodel.share_posterior_weights is shared
    data, masks, weights = _arrays(kind, incomplete, seed=4)
    key = jax.random.key(5)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, JStepInfo.create(epoch=1))
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    tmodel.draw_noise = _loss_noise(key, len(tmodel.subsets))
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights),
                               StepInfo(epoch=1))
    out.loss.backward()
    # the mean over the subsets, not divided by the rows
    assert out.loss_sum is out.loss
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"kl_1", "kl_2", "kl_3"}
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


def _assert_codes(out, ref):
    np.testing.assert_allclose(out.z.numpy(), _nchw(ref.z).numpy(), **VALUE_TOL)
    assert set(out.all_z) == set(ref.all_z) == {"z_1", "z_2", "z_3"}
    for k, v in out.all_z.items():
        np.testing.assert_allclose(v.numpy(), _nchw(ref.all_z[k]).numpy(), err_msg=k,
                                   **VALUE_TOL)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_encode_and_predict_match_jax(jax_models, kind):
    jmodel = jax_models(kind, True)
    tmodel = _port(jmodel, kind, True)
    data, _, _ = _arrays(kind, False, seed=6, n=4)
    with torch.no_grad():
        # three compiled encodes on the JAX side; predict reuses the second
        for i, (cond, N, flatten, mean) in enumerate((("all", 1, False, False),
                                                      (["m1", "m0"], 3, True, False),
                                                      ("m1", 3, False, True))):
            key = jax.random.key(10 + i)
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            tmodel.draw_noise = _level_noise(key)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            lead = (N, 4) if N > 1 and not flatten else (N * 4,)
            assert out.z.shape[:len(lead)] == lead and out.one_latent_space
            assert out.cond_mod == ref.cond_mod
            _assert_codes(out, ref)
        key = jax.random.key(20)
        ref = jmodel.predict(data, cond_mod="m0", gen_mod="all", N=3, rng=key)
        tmodel.draw_noise = _level_noise(key)
        out = tmodel.predict(data, cond_mod="m0", gen_mod="all", N=3)
    for m in tmodel.input_dims:
        assert out[m].shape == (3, 4, *tmodel.input_dims[m])
        np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                   **VALUE_TOL)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_per_sample_encode_of_an_incomplete_batch_matches_jax(jax_models, kind):
    """Each row conditioned on the modalities it has (a row with none on the
    prior expert alone), against the JAX masked encode over all modalities;
    ``encode`` keeps its availability error."""
    jmodel = jax_models(kind, False)
    tmodel = _port(jmodel, kind, False)
    data, masks, _ = _arrays(kind, True, seed=7)
    key = jax.random.key(8)
    encode = jax.jit(partial(jmodel._encode_masked, N=1, return_mean=False, flatten=False))
    ref = encode(jmodel.params, j_batch_from_arrays(data=data, masks=masks), key,
                 jmodel.subset_indicator(tuple(jmodel.encoders)))
    tmodel.draw_noise = _level_noise(key)
    batch = batch_from_arrays(data=data, masks=masks)
    with torch.no_grad():
        out = tmodel.encode_per_sample(batch)
    _assert_codes(out, JOutput(z=ref["z"], all_z=ref["all_z"]))
    with pytest.raises(AttributeError, match="incomplete dataset"):
        tmodel.encode(batch)


def test_checks_raise_like_jax():
    enc, dec, bu, td, post, prior = _port_mlp_blocks(True)
    jblocks = build_mhvae_blocks(MLP_DIMS, n_latent=3, latent_dim=MLP_LATENT)
    bad = {"bottom_up_blocks": lambda b: {"m0": b["m0"]},
           "top_down_blocks": lambda b: b[:1], "prior_blocks": lambda b: b[:1],
           "posterior_blocks": lambda b: b[:1]}
    for arg, cut in bad.items():
        messages = []
        for cls, cfg, blocks in ((JMHVAE, JMHVAEConfig, jblocks),
                                 (MHVAE, MHVAEConfig, (enc, dec, bu, td, post, prior))):
            kwargs = _block_kwargs(blocks)
            kwargs[arg] = cut(kwargs[arg])
            extra = {} if cls is JMHVAE else {"device": "cpu"}
            with pytest.raises(AttributeError) as e:
                cls(cfg(**_config_kwargs("mlp")), **kwargs, **extra)
            messages.append(str(e.value))
        assert messages[0] == messages[1], arg
    kwargs = _block_kwargs((enc, dec, bu, td, {"m0": post}, prior))
    with pytest.raises(AttributeError, match="keys of posterior_blocks"):
        MHVAE(MHVAEConfig(**_config_kwargs("mlp")), **kwargs, device="cpu")
    with pytest.raises(AttributeError, match="a list or a dict"):
        MHVAE(MHVAEConfig(**_config_kwargs("mlp")), **{**kwargs, "posterior_blocks": 3},
              device="cpu")
    tmodel = MHVAE(MHVAEConfig(**_config_kwargs("mlp")),
                   **_block_kwargs(_port_mlp_blocks(True)), device="cpu")
    with pytest.raises(NotImplementedError):
        tmodel.compute_joint_nll(MultimodalBaseDataset(_arrays("mlp", False)[0]))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "unshared"])
def test_save_and_reload_keep_every_block_group(tmp_path, shared):
    tmodel = MHVAE(MHVAEConfig(**_config_kwargs("conv")),
                   **_block_kwargs(_port_conv_blocks(shared)), device="cpu")
    assert sorted(tmodel.model_config.custom_architectures) == sorted(
        ["encoders", "decoders", "bottom_up_blocks", "top_down_blocks", "prior_blocks",
         "posterior_blocks"])
    tmodel.save(str(tmp_path))
    loaded = MHVAE.load_from_folder(str(tmp_path), device="cpu")
    assert loaded.share_posterior_weights is shared
    state = tmodel.state_dict()
    assert set(loaded.state_dict()) == set(state)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k
    data, masks, weights = _arrays("conv", True, seed=9, n=3)
    batch = batch_from_arrays(data=data, masks=masks, weights=weights)
    losses = []
    for model in (tmodel, loaded):
        model.draw_noise = lambda shape, generator=None: torch.ones(shape) * 0.1
        losses.append(model.loss_function(batch).loss.item())
    assert losses[0] == losses[1]


def test_trainer_curve_and_kept_weights_match_jax_trainer(jax_models, tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3) on 14 rows in batches of 6 (the
    last one padded) with an 8-row eval set, against the JAX trainer: the
    same weights, batch order and noise; the kept weights too."""
    jmodel = jax_models("mlp", False)
    start_params = jmodel.params
    tmodel = _port(jmodel, "mlp", False)
    data, eval_data = _arrays("mlp", False, seed=11, n=14)[0], _arrays("mlp", False,
                                                                    seed=12, n=8)[0]
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=6,
                  per_device_eval_batch_size=6, seed=SEED, optimizer_cls="Adam")
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JDataset(data), JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common),
                        callbacks=[rec])
    try:
        jtrainer.train()
        best = state_of(jtrainer.best_params)
    finally:
        jmodel.params = start_params    # the fixture's model serves other tests
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data),
                          MultimodalBaseDataset(eval_data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = feed_trainer_noise(trainer, tmodel, lambda key: _loss_noise(key, 3), SEED)
    trainer.train()
    assert next(steps) == 3 * 3                 # 3 epochs x 3 steps
    for key in ("train_epoch_loss", "eval_epoch_loss", "train_kl_1", "eval_kl_3"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 9 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    assert np.isclose(trainer.best_eval_loss, jtrainer.best_eval_loss, rtol=1e-4)
    assert_same_moves(trainer._best_state, best, start, 1e-3)
