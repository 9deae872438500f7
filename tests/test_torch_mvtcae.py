"""The port's MVTCAE against the JAX package's, on the CPU at a small size:
MLP nets (3 modalities, latent 8, hidden 16, batch 16) and the PolyMNIST
conv nets (2 modalities of 3x28x28, latent 8, batch 6), on complete batches
and on incomplete ones with a row that has no modality.

Weights cross with ``params_from_jax``; every Gaussian draw is made with
``jax.random`` as the JAX code makes it and handed to the port through the
model's ``draw_noise`` hook. Compared: loss, ``loss_sum``, every metric and
every parameter gradient; one Adam step; a 3-epoch ``BaseTrainer`` curve
with an eval set and ReduceLROnPlateau; encode / predict /
generate_from_prior; the joint and conditional NLL; the refusals; the config
JSON round-trip.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import jax
import optax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import (
    IncompleteDataset,
    MultimodalBaseDataset,
    batch_from_arrays,
)
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import normal

torch.set_num_threads(2)

LATENT, HID, SEED = 8, 16, 11
MLP_DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
MLP_DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
CONV_DIMS = {"m0": (3, 28, 28), "m1": (3, 28, 28)}
SIZES = {"mlp": 16, "conv": 6}
# Losses and metrics are sums of 10^2-10^4 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through up to 5 layers: 1e-4 relative, with an absolute floor of
# 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(nets):
    if nets == "mlp":
        return dict(n_modalities=3, latent_dim=LATENT, input_dims=MLP_DIMS,
                    uses_likelihood_rescaling=True, decoders_dist=dict(MLP_DISTS),
                    decoder_dist_params={"m2": {"scale": 0.75}}, alpha=0.3, beta=2.5)
    return dict(n_modalities=2, latent_dim=LATENT, input_dims=CONV_DIMS,
                decoders_dist={m: "laplace" for m in CONV_DIMS},
                decoder_dist_params={m: {"scale": 0.75} for m in CONV_DIMS},
                alpha=5.0 / 6.0, beta=2.5)


def _nets(nets, lib):
    if nets == "mlp":
        if lib == "jax":
            cfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in MLP_DIMS.items()}
            return ({m: JEncoder(c, hidden_dim=HID) for m, c in cfg.items()},
                    {m: JDecoder(c, hidden_dim=HID) for m, c in cfg.items()})
        cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in MLP_DIMS.items()}
        return ({m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                {m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()})
    # m0: conv latent heads; m1: the flatten + Dense heads encoder
    ns, Cfg = (jmmnist, JAEConfig) if lib == "jax" else (mmnist, BaseAEConfig)
    cfg = Cfg(latent_dim=LATENT, input_dim=(3, 28, 28))
    return ({"m0": ns.EncoderConvMMNIST_adapted(cfg), "m1": ns.EncoderConvMMNIST(cfg)},
            {m: ns.DecoderConvMMNIST(cfg) for m in CONV_DIMS})


def _models(nets="mlp"):
    enc, dec = _nets(nets, "jax")
    jmodel = JMVTCAE(JMVTCAEConfig(**_config_kwargs(nets)), encoders=enc,
                     decoders=dec, seed=0)
    enc, dec = _nets(nets, "torch")
    tmodel = MVTCAE(MVTCAEConfig(**_config_kwargs(nets)), encoders=enc,
                    decoders=dec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, tmodel


def _arrays(nets, incomplete, seed=0, n=None):
    dims = MLP_DIMS if nets == "mlp" else CONV_DIMS
    n = n or SIZES[nets]
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in dims.items()}
    if not incomplete:
        return data, None, None
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in dims}
    for m in dims:
        masks[m][0] = 1.0        # a complete row
        masks[m][1] = 0.0        # a row with no modality: the PoE falls back
    masks["m0"][2], masks["m1"][2] = 0.0, 1.0
    for m in dims:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0            # a loader padding row
    return data, masks, weights


class _JaxNoise:
    """The model's ``draw_noise`` hook, returning ``jax.random.normal`` of
    the key sequence the JAX code uses: one fixed key, or (``chain``) the
    carry key split once per draw, as the chunked estimators do."""

    def __init__(self, key, chain=False):
        self.key, self.chain, self.shapes = key, chain, []

    def __call__(self, shape, generator=None):
        self.shapes.append(tuple(shape))
        key = self.key
        if self.chain:
            self.key, key = jax.random.split(self.key)
        return normal(key, shape)


def _jax_loss_fn(jmodel, arrays, key):
    """params -> ((loss, ModelOutput), grads) of the JAX model, jitted."""
    data, masks, weights = arrays
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=len(next(iter(data.values()))))

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _jax_loss(jmodel, arrays, key, fn=None):
    (_, out), grads = (fn or _jax_loss_fn(jmodel, arrays, key))(jmodel.params)
    return out, grads


def _port_loss(tmodel, arrays, key):
    data, masks, weights = arrays
    batch = batch_from_arrays(data=data, masks=masks, weights=weights)
    tmodel.draw_noise = _JaxNoise(key)
    return tmodel.loss_function(batch)


def _assert_grads_close(tmodel, jgrads):
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("incomplete", [False, True])
@pytest.mark.parametrize("nets", ["mlp", "conv"])
def test_loss_metrics_and_every_gradient_match_jax(nets, incomplete):
    jmodel, tmodel = _models(nets)
    arrays = _arrays(nets, incomplete)
    key = jax.random.key(1)
    ref, jgrads = _jax_loss(jmodel, arrays, key)
    out = _port_loss(tmodel, arrays, key)
    out.loss.backward()
    assert tmodel.draw_noise.shapes == [(SIZES[nets], LATENT)]
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics)
    for k, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[k]), err_msg=k,
                                   **LOSS_TOL)
    _assert_grads_close(tmodel, jgrads)


def test_one_adam_step_matches_jax():
    jmodel, tmodel = _models("mlp")
    arrays, key, lr = _arrays("mlp", True, seed=2), jax.random.key(3), 1e-2
    fn = _jax_loss_fn(jmodel, arrays, key)
    _, jgrads = _jax_loss(jmodel, arrays, key, fn)
    opt = optax.adam(lr)
    updates, _ = jax.jit(opt.update)(jgrads, opt.init(jmodel.params), jmodel.params)
    jmodel.params = optax.apply_updates(jmodel.params, updates)
    ref_after, _ = _jax_loss(jmodel, arrays, key, fn)

    optim = torch.optim.Adam(tmodel.parameters(), lr=lr)
    _port_loss(tmodel, arrays, key).loss.backward()
    optim.step()
    expected = params_from_jax(jax.tree.map(np.asarray, jmodel.params))
    for name, p in tmodel.named_parameters():
        # one Adam step moves each weight by ~lr * g/|g|; g's 1e-4 relative
        # error moves that by < 1e-6 except where |g| ~ eps (1e-8)
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(),
                                   rtol=0, atol=2e-6, err_msg=name)
    with torch.no_grad():
        after = _port_loss(tmodel, arrays, key).loss.item()
    np.testing.assert_allclose(after, float(ref_after.loss), **LOSS_TOL)


class _Recorder(TrainingCallback):
    def __init__(self):
        self.logs = []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3, ReduceLROnPlateau on the eval
    loss, set to cut the rate every epoch) on 40 incomplete rows in batches
    of 16 (the last one padded), with a 24-row eval set, against the JAX
    trainer: same weights and batch order, and the port's ``draw_noise``
    patched to the JAX trainer's draws (train: ``fold_in(key(seed),
    step)``; eval: ``key(seed + 1000 + epoch)`` for every batch)."""
    data, masks, _ = _arrays("mlp", True, seed=4, n=40)
    eval_data, _, _ = _arrays("mlp", False, seed=5, n=24)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=16,
                  per_device_eval_batch_size=16, seed=SEED, optimizer_cls="Adam",
                  scheduler_cls="ReduceLROnPlateau",
                  scheduler_params={"mode": "max", "patience": 0, "factor": 0.5})
    jmodel, tmodel = _models("mlp")

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

    def jax_trainer_noise(shape, generator=None):
        if generator is trainer.generator:
            key = jax.random.fold_in(jax.random.key(SEED), next(steps))
        else:
            key = jax.random.key(generator.initial_seed())
        return normal(key, shape)

    tmodel.draw_noise = jax_trainer_noise
    trainer.train()
    assert next(steps) == 3 * 3                 # 3 epochs x 3 steps
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 9 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    # epoch 1 sets the best; epochs 2 and 3 each halve the rate
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 / 4)


@pytest.mark.parametrize("nets", ["mlp", "conv"])
def test_encode_predict_generate_match_jax(nets):
    jmodel, tmodel = _models(nets)
    data, _, _ = _arrays(nets, False, seed=6)
    n, cond = SIZES[nets], ["m0"] if nets == "conv" else ["m0", "m2"]
    key = jax.random.key(7)
    with torch.no_grad():
        for N, flatten, mean, shape in ((3, True, False, (3 * n, LATENT)),
                                        (3, False, False, (3, n, LATENT)),
                                        (1, False, False, (n, LATENT)),
                                        (2, False, True, (2, n, LATENT))):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            tmodel.draw_noise = _JaxNoise(key)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == shape == ref.z.shape
            assert out.one_latent_space and out.cond_mod == cond == ref["cond_mod"]
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=cond, gen_mod="all", N=3, rng=key)
        tmodel.draw_noise = _JaxNoise(key)
        out = tmodel.predict(data, cond_mod=cond, gen_mod="all", N=3)
        dims = MLP_DIMS if nets == "mlp" else CONV_DIMS
        for m, d in dims.items():
            assert out[m].shape == (3, n, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), **VALUE_TOL)
        flat = tmodel.predict(data, cond_mod=cond, gen_mod="m1", N=3, flatten=True)
        assert list(flat) == ["m1"] and flat["m1"].shape == (3 * n, *dims["m1"])

        for n_samples, shape in ((5, (5, LATENT)), (1, (LATENT,))):
            ref = jmodel.generate_from_prior(n_samples, rng=key)
            tmodel.draw_noise = _JaxNoise(key)
            out = tmodel.generate_from_prior(n_samples)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            rec, jrec = tmodel.decode(out, "m1"), jmodel.decode(ref, "m1")
            assert rec["m1"].shape == (*shape[:-1], *dims["m1"])
            np.testing.assert_allclose(rec["m1"].numpy(), np.asarray(jrec["m1"]),
                                       **VALUE_TOL)


@pytest.mark.parametrize("nets", ["mlp", "conv"])
def test_joint_nll_matches_jax(nets):
    jmodel, tmodel = _models(nets)
    data, _, _ = _arrays(nets, False, seed=8)
    key = jax.random.key(9)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    tmodel.draw_noise = _JaxNoise(key, chain=True)
    out = tmodel.compute_joint_nll(data, K=K, batch_size_K=chunk)
    n = SIZES[nets]
    assert tmodel.draw_noise.shapes == [(3, n, LATENT), (3, n, LATENT), (1, n, LATENT)]
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)


def test_cond_nll_matches_jax():
    jmodel, tmodel = _models("mlp")
    data, _, _ = _arrays("mlp", False, seed=10)
    key = jax.random.key(11)
    ref = jmodel.compute_cond_nll(data, ["m0"], ["m1", "m2"], k_iwae=7,
                                  batch_size_k=3, rng=key)
    tmodel.draw_noise = _JaxNoise(key, chain=True)
    out = tmodel.compute_cond_nll(data, ["m0"], ["m1", "m2"], k_iwae=7, batch_size_k=3)
    n = SIZES["mlp"]
    assert tmodel.draw_noise.shapes == [(3, n, LATENT), (3, n, LATENT), (n, LATENT)]
    assert set(out) == set(ref) == {"m1", "m2"}
    for m in out:
        np.testing.assert_allclose(out[m].item(), float(ref[m]), err_msg=m, **LOSS_TOL)


def test_encode_and_nll_refuse_incomplete_data():
    jmodel, tmodel = _models("mlp")
    data, masks, _ = _arrays("mlp", True, seed=12)
    tds, jds = IncompleteDataset(data, masks), JIncompleteDataset(data, masks)
    for model, ds in ((jmodel, jds), (tmodel, tds)):
        with pytest.raises(AttributeError, match="incomplete dataset"):
            model.encode(ds, cond_mod="m1")
        with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
            model.compute_joint_nll(ds, K=4, batch_size_K=2)
        with pytest.raises(AttributeError, match="neither"):
            model.encode(ds, cond_mod="m9")
    # ignore_incomplete encodes anyway; a complete subset passes the check
    tmodel.encode(tds, cond_mod="m1", ignore_incomplete=True)
    full = {m: np.ones_like(v) for m, v in masks.items()}
    tmodel.encode(IncompleteDataset(data, full), cond_mod="all")


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs("mlp")
    jcfg, tcfg = JMVTCAEConfig(**kw), MVTCAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert MVTCAEConfig().alpha == 0.1 and MVTCAEConfig().beta == 2.5
    jcfg.save_json(str(tmp_path), "model_config")
    assert MVTCAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "MVTCAEConfig"
    assert JMVTCAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_save_and_reload_with_conv_nets(tmp_path):
    _, tmodel = _models("conv")
    tmodel.save(str(tmp_path))
    reloaded = MVTCAE.load_from_folder(str(tmp_path), device="cpu")
    assert isinstance(reloaded.encoders["m1"], mmnist.EncoderConvMMNIST)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
