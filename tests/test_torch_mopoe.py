"""The port's MoPoE against the JAX package's, on the CPU at a small size:
3 modalities on the MLP nets (hidden 16), latent 8, batch 8, with one
shared latent space or with private ones (the multi-latent MLP nets), with
every subset or a custom list, on complete batches (the index-range split
over subsets) and on incomplete ones (a subset drawn per row among the
available ones) with a row that has no modality.

Weights cross with ``params_from_jax``; every Gaussian draw is made with
``jax.random`` as the JAX code makes it and the per-row subsets with its
``jax.random.categorical``, handed to the port through ``draw_noise`` and
``draw_components``. Compared: the loss, ``loss_sum``, every metric and
every parameter gradient; a 3-epoch ``BaseTrainer`` curve with
``drop_last`` and an eval set; encode (with the full subset's
``return_mean`` quirk) / predict / generate_from_prior; the mixture joint
NLL, the paper's and a subset's; the subsets' names and refusals.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MoPoE as JMoPoE
from multivae_tpu.models import MoPoEConfig as JMoPoEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.callbacks import TrainingCallback
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import MoPoE, MoPoEConfig
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import normal

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
STYLE = {"m0": 2, "m1": 3, "m2": 2}
CUSTOM = [["m1", "m0"], ["m2"], [], ["m0", "m1", "m2"]]
LATENT, HID, B, SEED = 8, 16, 8, 11
M = len(DIMS)
# Losses and metrics are sums of 10^2-10^3 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through the subset PoEs and 2 layers: 1e-4 relative, with an
# absolute floor of 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(multi=False, subsets=None):
    return dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
                uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
                decoder_dist_params={"m2": {"scale": 0.75}}, beta=2.5, beta_style=0.7,
                subsets=subsets, modalities_specific_dim=dict(STYLE) if multi else None)


def _nets(lib, multi):
    ml, Cfg = (jdefault, JAEConfig) if lib == "jax" else (default, BaseAEConfig)
    if multi:
        enc = {m: ml.Encoder_VAE_MLP_Style(Cfg(input_dim=d, latent_dim=LATENT,
                                               style_dim=STYLE[m]), hidden_dim=HID)
               for m, d in DIMS.items()}
        dec = {m: ml.Decoder_AE_MLP(Cfg(input_dim=d, latent_dim=LATENT + STYLE[m]),
                                    hidden_dim=HID) for m, d in DIMS.items()}
        return enc, dec
    cfg = {m: Cfg(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    return ({m: ml.Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
            {m: ml.Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()})


def _models(multi=False, subsets=None):
    enc, dec = _nets("jax", multi)
    jmodel = JMoPoE(JMoPoEConfig(**_config_kwargs(multi, subsets)), encoders=enc,
                    decoders=dec, seed=0)
    enc, dec = _nets("torch", multi)
    tmodel = MoPoE(MoPoEConfig(**_config_kwargs(multi, subsets)), encoders=enc,
                   decoders=dec, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, tmodel


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


def _normal(key, shape):
    return normal(key, shape)


class _JaxDraws:
    """``draw_noise`` / ``draw_components`` hooks returning the JAX
    package's draws of one ``loss_function(rng)`` call: the subset per row
    ``categorical(sel_rng, logits)``, the shared code's noise
    ``normal(z_rng)``, then each private code's ``normal(style_rngs[i])``."""

    def __init__(self, rng):
        _, self.sel_rng, z_rng, style_rng = jax.random.split(rng, 4)
        self.keys = [z_rng] + list(jax.random.split(style_rng, M))
        self.calls = []

    def noise(self, shape, generator=None):
        self.calls.append(tuple(shape))
        return _normal(self.keys.pop(0), shape)

    def components(self, logits, generator=None):
        self.calls.append("components")
        return torch.tensor(np.asarray(jax.random.categorical(
            self.sel_rng, jnp.asarray(logits.numpy()), axis=-1)))

    def install(self, model):
        model.draw_noise, model.draw_components = self.noise, self.components
        return self


CASES = {"complete": (False, None, False), "incomplete": (False, None, True),
         "multilatent_incomplete": (True, None, True), "custom_subsets": (False, CUSTOM, False),
         "custom_subsets_incomplete": (False, CUSTOM, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_metrics_and_every_gradient_match_jax(case):
    multi, subsets, incomplete = CASES[case]
    jmodel, tmodel = _models(multi, subsets)
    data, masks, weights = _arrays(incomplete)
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    draws = _JaxDraws(key).install(tmodel)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights))
    out.loss.backward()
    # the random selection runs on incomplete batches only
    assert draws.calls == (["components"] if incomplete else []) + [(B, LATENT)] + (
        [(B, STYLE[m]) for m in DIMS] if multi else [])
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics) == {"joint_divergence", "recon_m0",
                                                    "recon_m1", "recon_m2"}
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_component_selection_branches():
    """Complete data: rows split into S equal index ranges (the remainder to
    the last subset). Incomplete data: each row's subset is one whose
    modalities are all available, drawn uniformly among all where none is."""
    _, tmodel = _models()
    data, masks, _ = _arrays(True, n=16)
    S, rows = len(tmodel.subsets), np.arange(16)
    batch = batch_from_arrays(data, masks=masks)
    picks, logits_seen = [], []

    def record(logits, generator=None):
        logits_seen.append(logits)
        picks.append(MoPoE.draw_components(tmodel, logits, generator))
        return picks[-1]

    tmodel.draw_components = record
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        complete = tmodel._inference(batch, incomplete=False)
        assert not picks
        np.testing.assert_array_equal(
            complete["joint"][0].numpy(),
            complete["mus"].numpy()[np.minimum(rows // (16 // S), S - 1), rows])
        for _ in range(20):
            inc = tmodel._inference(batch, incomplete=True, generator=gen)
        avail = tmodel._availabilities(batch).numpy()                  # (S, B)
    picks = torch.stack(picks).numpy()                                  # (20, B)
    for r in rows:
        if avail[:, r].any():
            assert avail[picks[:, r], r].all(), r
    np.testing.assert_array_equal(logits_seen[0][1].numpy(), np.full(S, np.log(1e-12),
                                                                     np.float32))
    np.testing.assert_array_equal(inc["joint"][0].numpy(),
                                  inc["mus"].numpy()[picks[-1], rows])


class _Recorder(TrainingCallback):
    def __init__(self):
        self.logs = []

    def on_log(self, training_config, logs, **kwargs):
        self.logs.append(dict(logs))


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3, ``drop_last``) on 20 incomplete
    rows in batches of 8 (2 a epoch), with a 16-row complete eval set, against
    the JAX trainer: same weights and batch order, the port's draws patched
    to the JAX trainer's (train: ``fold_in(key(seed), step)``; eval:
    ``key(seed + 1000 + epoch)``)."""
    data, masks, _ = _arrays(True, seed=5, n=20)
    eval_data, _, _ = _arrays(False, seed=6, n=16)
    common = dict(num_epochs=3, learning_rate=1e-3, per_device_train_batch_size=8,
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
    state = {"step": 0}

    def draws(generator):
        if generator is trainer.generator:
            return _JaxDraws(jax.random.fold_in(jax.random.key(SEED), state["step"]))
        return _JaxDraws(jax.random.key(generator.initial_seed()))

    def components(logits, generator=None):
        return draws(generator).components(logits)

    def noise(shape, generator=None):
        value = draws(generator).noise(shape)
        state["step"] += generator is trainer.generator
        return value

    tmodel.draw_noise, tmodel.draw_components = noise, components
    trainer.train()
    assert state["step"] == 3 * 2                 # 3 epochs x 2 steps
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 6 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)


def _encode_keys(key):
    rest, z_rng = jax.random.split(key)
    return [z_rng] + list(jax.random.split(rest, M))


@pytest.mark.parametrize("multi", [False, True])
def test_encode_predict_generate_match_jax(multi):
    jmodel, tmodel = _models(multi)
    data, _, _ = _arrays(False, seed=6)
    key = jax.random.key(7)
    with torch.no_grad():
        for cond, N, flatten, mean in ((["m0", "m2"], 3, True, False),
                                       ("all", 1, False, False),
                                       ("all", 2, False, True),       # mean of all subsets
                                       (["m2", "m0"], 1, False, True)):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            keys = iter(_encode_keys(key))
            tmodel.draw_noise = lambda shape, generator=None: _normal(next(keys), shape)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == ref.z.shape and out.one_latent_space == (not multi)
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            if multi:
                for m in DIMS:
                    np.testing.assert_allclose(out.modalities_z[m].numpy(),
                                               np.asarray(ref["modalities_z"][m]),
                                               err_msg=m, **VALUE_TOL)
        ref = jmodel.predict(data, cond_mod=["m0"], gen_mod="all", N=3, rng=key)
        keys = iter(_encode_keys(key))
        out = tmodel.predict(data, cond_mod=["m0"], gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)
        if not multi:
            ref = jmodel.generate_from_prior(5, rng=key)
            tmodel.draw_noise = lambda shape, generator=None: _normal(key, shape)
            out = tmodel.generate_from_prior(5)
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            rec, jrec = tmodel.decode(out, "m2"), jmodel.decode(ref, "m2")
            np.testing.assert_allclose(rec["m2"].numpy(), np.asarray(jrec["m2"]),
                                       **VALUE_TOL)


def _chain(key, n):
    """The keys ``lax.scan`` hands out: the carry split once per chunk."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


# the paper's estimator is the subset estimator on the full subset
@pytest.mark.parametrize("method, multi", [("joint_nll", False), ("joint_nll", True),
                                           ("joint_nll_paper", False), ("subset", True)])
def test_joint_nlls_match_jax(method, multi):
    jmodel, tmodel = _models(multi)
    data, _, _ = _arrays(False, seed=8)
    key = jax.random.key(9)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    if method == "subset":
        call = lambda model, **kw: model._compute_joint_nll_from_subset_encoding(  # noqa: E731
            ["m1", "m0"], data, K=K, batch_size_K=chunk, **kw)
    else:
        call = lambda model, **kw: getattr(model, f"compute_{method}")(  # noqa: E731
            data, K=K, batch_size_K=chunk, **kw)
    ref = float(call(jmodel, rng=key))
    # the mixture estimator splits off its selection key first
    scan_key = jax.random.split(key)[0] if method == "joint_nll" else key
    keys, shapes = [], []
    for sub in _chain(scan_key, 3):
        _, z_rng, p_rng = jax.random.split(sub, 3)
        keys += [z_rng] + (list(jax.random.split(p_rng, M)) if multi else [])
    queue = iter(keys)

    def noise(shape, generator=None):
        shapes.append(tuple(shape))
        return _normal(next(queue), shape)

    tmodel.draw_noise = noise
    out = call(tmodel)
    assert shapes[0] == (3, B, LATENT) and len(shapes) == len(keys)
    assert out.shape == () and not out.requires_grad
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
    with pytest.raises(AttributeError, match="not yet implemented for incomplete"):
        tmodel.compute_joint_nll(IncompleteDataset(*_arrays(True)[:2]), K=K)


def test_subsets_names_and_refusals():
    jmodel, tmodel = _models(subsets=CUSTOM)
    assert tmodel.subsets == jmodel.subsets == {
        "m0_m1": ["m0", "m1"], "m2": ["m2"], "m0_m1_m2": ["m0", "m1", "m2"]}
    assert tmodel.model_config.subsets == tmodel.subsets
    np.testing.assert_array_equal(tmodel._subset_mask.numpy(),
                                  np.asarray(jmodel._subset_mask))
    np.testing.assert_array_equal(tmodel._full_subset_flag.numpy(),
                                  np.asarray(jmodel._full_subset_flag))
    data, _, _ = _arrays(False)
    for model in (tmodel, jmodel):
        with pytest.raises(AttributeError, match="not in the model's subsets"):
            model.encode(data, cond_mod=["m0"])
    with pytest.raises(AttributeError, match="unknown modality name m7"):
        MoPoE(MoPoEConfig(**_config_kwargs(subsets=[["m0", "m7"]])), device="cpu")
    _, full = _models()
    assert list(full.subsets) == ["m0", "m1", "m2", "m0_m1", "m0_m2", "m1_m2", "m0_m1_m2"]
    named = MoPoE(MoPoEConfig(**_config_kwargs(subsets={"a": ["m2", "m1"], "b": ["m0"]})),
                  device="cpu")
    assert list(named.subsets) == ["m1_m2", "m0"]


def test_config_json_round_trip_with_jax(tmp_path):
    for kw in (_config_kwargs(True, CUSTOM), _config_kwargs()):
        jcfg, tcfg = JMoPoEConfig(**kw), MoPoEConfig(**kw)
        assert jcfg.to_dict() == tcfg.to_dict()
        jcfg.save_json(str(tmp_path), "model_config")
        assert MoPoEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
        tcfg.save_json(str(tmp_path), "port_config")
        with open(tmp_path / "port_config.json") as f:
            assert json.load(f)["name"] == "MoPoEConfig"
        assert JMoPoEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg
    assert MoPoEConfig().to_dict() == JMoPoEConfig().to_dict()


def test_default_nets_save_and_reload(tmp_path):
    dims = {"a": (5,), "b": (1, 2, 3)}
    for specific in (None, {"a": 2, "b": 3}):
        model = MoPoE(MoPoEConfig(n_modalities=2, latent_dim=LATENT, input_dims=dims,
                                  modalities_specific_dim=specific), seed=3, device="cpu")
        assert isinstance(model.encoders["a"], default.Encoder_VAE_MLP_Style
                          if specific else default.Encoder_VAE_MLP)
        data = {m: np.random.default_rng(0).uniform(size=(4, *d)).astype(np.float32)
                for m, d in dims.items()}
        out = model(data, generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out.loss)
        model.save(str(tmp_path))
        reloaded = MoPoE.load_from_folder(str(tmp_path), device="cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(reloaded.state_dict()[k], v), k
        # the config JSON sorts its keys (in both packages): a reloaded model
        # lists the same subsets in sorted order
        assert list(reloaded.subsets) == sorted(model.subsets)
