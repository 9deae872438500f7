"""The port's MVAE and ``ops/subsets`` against the JAX package's, on the CPU
at a small size: 3 modalities on the MLP nets (hidden 16), latent 8, batch
8, on complete batches and on incomplete ones with a row that has no
modality.

Weights cross with ``params_from_jax``; the Gaussian noise of each subset
ELBO is ``jax.random.normal`` of the subset's key and the random subsets
are ``jax.random.choice`` of the JAX code, handed to the port through
``draw_noise`` and ``draw_subsets``. Compared: the loss, ``loss_sum``,
every metric and every parameter gradient with and without sub-sampling,
with k random subsets and during the KL warm-up; the eval-mode objective
(no random subsets) against the JAX package's ``eval_loss_function``; a
3-epoch ``BaseTrainer`` curve with an eval set, and a 4-epoch one without,
with the kept weights of the keep-best window; encode / predict /
generate_from_prior; the joint NLL; the config JSON round-trip.
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
from multivae_tpu.models import MVAE as JMVAE
from multivae_tpu.models import MVAEConfig as JMVAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.ops import subsets as jsubsets
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import MVAE, MVAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops import subsets
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import Recorder, assert_same_moves, normal, state_of

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
DISTS = {"m0": "normal", "m1": "bernoulli", "m2": "laplace"}
LATENT, HID, B, SEED = 8, 16, 8, 11
M = len(DIMS)
# Losses and metrics are sums of 10^2-10^3 float32 terms taken in another
# order by XLA and by PyTorch: 1e-5 relative. Gradients are such sums
# pushed through the PoE and 2 layers: 1e-4 relative, with an absolute
# floor of 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# Latent samples and decoder outputs: elementwise, a few ulps of O(1).
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
              uses_likelihood_rescaling=True, decoders_dist=dict(DISTS),
              decoder_dist_params={"m2": {"scale": 0.75}}, beta=2.5, warmup=0)
    kw.update(extra)
    return kw


def _models(**extra):
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    jmodel = JMVAE(JMVAEConfig(**_config_kwargs(**extra)),
                   encoders={m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                   decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                   seed=0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    tmodel = MVAE(MVAEConfig(**_config_kwargs(**extra)),
                  encoders={m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                  decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                  device="cpu")
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
    """``draw_noise`` / ``draw_subsets`` hooks returning the JAX package's
    draws of one ``loss_function(rng)`` call: subset s's noise is
    ``normal(sub_rngs[s])``, the random subsets ``choice(choice_rng)``."""

    def __init__(self, rng, k):
        rng, *self.sub_rngs = jax.random.split(rng, 2 + M + k)
        self.choice_rng = jax.random.split(rng)[1]
        self.calls = []

    def noise(self, shape, generator=None):
        self.calls.append(("noise", tuple(shape)))
        return torch.stack([_normal(k, shape[1:]) for k in self.sub_rngs[:shape[0]]])

    def subsets(self, n_candidates, k, generator=None):
        self.calls.append(("subsets", n_candidates, k))
        return torch.tensor(np.asarray(jax.random.choice(
            self.choice_rng, n_candidates, shape=(k,), replace=False)))

    def install(self, model):
        model.draw_noise, model.draw_subsets = self.noise, self.subsets
        return self


def test_subsets_match_jax():
    for mods in (["a"], ["m0", "m1", "m2"], list("abcde")):
        for empty, full in itertools.product((False, True), repeat=2):
            ours = subsets.all_subsets(mods, include_empty=empty, include_full=full)
            assert ours == jsubsets.all_subsets(mods, include_empty=empty,
                                                include_full=full)
            np.testing.assert_array_equal(subsets.subsets_to_mask(ours, mods),
                                          jsubsets.subsets_to_mask(ours, mods))
            names, mask = subsets.all_subsets_mask(mods, empty, full)
            jnames, jmask = jsubsets.all_subsets_mask(mods, empty, full)
            assert names == jnames and mask.dtype == jmask.dtype == np.float32
            np.testing.assert_array_equal(mask, jmask)
    assert len(subsets.all_subsets(list("abcde"))) == 31


# (use_subsampling, k, incomplete, epoch, batch_ratio, warmup)
CASES = {
    "joint_and_unimodal": (True, 0, False, 1, 0.0, 0),
    "k_random_incomplete": (True, 2, True, 1, 0.0, 0),
    "joint_only_incomplete": (False, 0, True, 1, 0.0, 0),
    "warmup": (True, 1, True, 2, 0.5, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_metrics_and_every_gradient_match_jax(case):
    subsampling, k, incomplete, epoch, ratio, warmup = CASES[case]
    jmodel, tmodel = _models(use_subsampling=subsampling, k=k, warmup=warmup)
    data, masks, weights = _arrays(incomplete)
    key = jax.random.key(1)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=epoch, batch_ratio=ratio, dataset_size=B)

    def loss(params):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    draws = _JaxDraws(key, k).install(tmodel)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights),
                               StepInfo(epoch=epoch, batch_ratio=ratio, dataset_size=B))
    out.loss.backward()
    S = 1 + (M if subsampling else 0) + k
    assert draws.calls == ([("subsets", 3, k)] if k else []) + [("noise", (S, B, LATENT))]
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics)
    assert ("random_subset_0" in out.metrics) == (k > 0)
    assert {"beta", "m0_m1_m2", "kldm0_m1_m2", "reconm0_m1_m2"} <= set(out.metrics)
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    expected_beta = 2.5 if warmup == 0 else (epoch - 1 + ratio) / warmup * 2.5
    np.testing.assert_allclose(out.metrics["beta"].item(), expected_beta, rtol=1e-6)
    ref_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_eval_mode_draws_no_random_subsets_like_jax_eval_loss_function():
    """In eval mode (``model.eval()``, as the trainer's eval pass sets it)
    the port skips the random subsets, as the JAX package's
    ``eval_loss_function`` does; in train mode it draws them."""
    jmodel, tmodel = _models(k=2)
    data, masks, weights = _arrays(True, seed=3)
    key = jax.random.key(4)
    jbatch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    step = JStepInfo.create(epoch=1, dataset_size=B)
    ref = jax.jit(lambda p: jmodel.eval_loss_function(p, jbatch, key, step))(jmodel.params)
    batch = batch_from_arrays(data=data, masks=masks, weights=weights)
    tmodel.eval()
    draws = _JaxDraws(key, 2).install(tmodel)
    with torch.no_grad():
        out = tmodel.loss_function(batch, StepInfo(epoch=1, dataset_size=B))
    assert draws.calls == [("noise", (1 + M, B, LATENT))]
    assert not any(k.startswith("random_subset") for k in out.metrics)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    tmodel.train()
    draws = _JaxDraws(key, 2).install(tmodel)
    with torch.no_grad():
        out = tmodel.loss_function(batch, StepInfo(epoch=1, dataset_size=B))
    assert draws.calls[0] == ("subsets", 3, 2)
    assert {"random_subset_0", "random_subset_1"} <= set(out.metrics)


def _feed_jax_trainer_draws(trainer, tmodel):
    """Patch the port's draws to the JAX trainer's (train:
    ``fold_in(key(seed), step)``; eval, without random subsets:
    ``key(seed + 1000 + epoch)``); returns the step counter and the log of
    draw calls."""
    steps, calls = itertools.count(), []

    def draws_for(generator):
        if generator is trainer.generator:
            return _JaxDraws(jax.random.fold_in(jax.random.key(SEED), next(steps)), 1)
        return _JaxDraws(jax.random.key(generator.initial_seed()), 1)

    current = {}

    def subsets_hook(n, k, generator=None):
        current["draws"] = draws_for(generator)
        calls.append("subsets")
        return current["draws"].subsets(n, k)

    def noise_hook(shape, generator=None):
        if not tmodel.training:
            current["draws"] = draws_for(generator)
        calls.append("train" if tmodel.training else "eval")
        return current["draws"].noise(shape)

    tmodel.draw_noise, tmodel.draw_subsets = noise_hook, subsets_hook
    return steps, calls


def _trainer_pair(tmp_path, data, masks, eval_data, num_epochs):
    """The JAX trainer (trained, with its logged epochs) and the port's, on
    the same weights: Adam 1e-3, a 2-epoch warm-up, one random subset a
    train step, batches of 8."""
    common = dict(num_epochs=num_epochs, learning_rate=1e-3,
                  per_device_train_batch_size=8, per_device_eval_batch_size=8,
                  seed=SEED, optimizer_cls="Adam")
    jmodel, tmodel = _models(k=1, warmup=2)
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JIncompleteDataset(data, masks),
                        None if eval_data is None else JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common),
                        callbacks=[rec])
    jtrainer.train()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks),
                          None if eval_data is None else MultimodalBaseDataset(eval_data),
                          device="cpu", training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    return jtrainer, rec, trainer, tmodel, start


def test_trainer_curve_matches_jax_trainer(tmp_path):
    """3 epochs of BaseTrainer (Adam 1e-3, a 2-epoch warm-up, one random
    subset a train step) on 20 incomplete rows in batches of 8 (the last one
    padded), with a 16-row eval set, against the JAX trainer: same weights
    and batch order, the port's draws patched to the JAX trainer's (train:
    ``fold_in(key(seed), step)``; eval, without random subsets:
    ``key(seed + 1000 + epoch)``). Every epoch is in the keep-best window
    (``start_keep_best_epoch`` 3): both keep the last epoch's weights and
    leave the best eval loss at inf."""
    data, masks, _ = _arrays(True, seed=5, n=20)
    eval_data, _, _ = _arrays(False, seed=6, n=16)
    jtrainer, rec, trainer, tmodel, start = _trainer_pair(tmp_path, data, masks,
                                                          eval_data, 3)
    steps, calls = _feed_jax_trainer_draws(trainer, tmodel)
    trainer.train()
    assert next(steps) == 3 * 3                 # 3 epochs x 3 steps
    # each train step draws its subset, then its noise; eval steps draw noise only
    assert calls == (["subsets", "train"] * 3 + ["eval"] * 2) * 3
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 9 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    assert "train_random_subset_0" in trainer.history[0]
    assert "eval_random_subset_0" not in trainer.history[0]
    assert trainer.best_eval_loss == jtrainer.best_eval_loss == np.inf
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
    for name, v in tmodel.state_dict().items():
        assert torch.equal(trainer._best_state[name], v), name


def test_trainer_without_eval_set_keeps_the_first_epoch_after_warmup(tmp_path):
    """Without an eval set an epoch after the keep-best window counts as no
    better than the best so far (inf): the JAX trainer and the port keep
    epoch ``warmup + 1`` = 3 of 4, not the last one."""
    data, masks, _ = _arrays(True, seed=5, n=20)
    jtrainer, rec, trainer, tmodel, start = _trainer_pair(tmp_path, data, masks, None, 4)
    _feed_jax_trainer_draws(trainer, tmodel)
    snapshots = []
    finalize = trainer._finalize_epoch

    def finalize_and_record(*args):
        finalize(*args)
        snapshots.append({k: v.clone() for k, v in tmodel.state_dict().items()})

    trainer._finalize_epoch = finalize_and_record
    trainer.train()
    np.testing.assert_allclose([h["train_epoch_loss"] for h in trainer.history],
                               [h["train_epoch_loss"] for h in rec.logs], rtol=1e-4)
    assert trainer.best_eval_loss == jtrainer.best_eval_loss == np.inf
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
    for name, v in trainer._best_state.items():
        assert torch.equal(v, snapshots[2][name]), name
    assert any(not torch.equal(v, snapshots[3][k]) for k, v in trainer._best_state.items())
    assert trainer.best_model is tmodel
    for name, v in tmodel.state_dict().items():
        assert torch.equal(v, snapshots[2][name]), name


def test_encode_predict_generate_match_jax():
    jmodel, tmodel = _models()
    data, _, _ = _arrays(False, seed=6)
    key = jax.random.key(7)

    def noise(shape, generator=None):
        return _normal(key, shape)

    with torch.no_grad():
        for cond, N, flatten, mean, shape in (
                (["m0", "m2"], 3, True, False, (3 * B, LATENT)),
                (["m1"], 3, False, False, (3, B, LATENT)),
                ("all", 1, False, False, (B, LATENT)),
                (["m2", "m0"], 2, False, True, (2, B, LATENT))):
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            tmodel.draw_noise = noise
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.z.shape == shape == ref.z.shape and out.one_latent_space
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)

        ref = jmodel.predict(data, cond_mod=["m0"], gen_mod="all", N=3, rng=key)
        out = tmodel.predict(data, cond_mod=["m0"], gen_mod="all", N=3)
        for m, d in DIMS.items():
            assert out[m].shape == (3, B, *d) == ref[m].shape
            np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                       **VALUE_TOL)
        ref = jmodel.generate_from_prior(5, rng=key)
        out = tmodel.generate_from_prior(5)
        np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
        rec, jrec = tmodel.decode(out, "m2"), jmodel.decode(ref, "m2")
        np.testing.assert_allclose(rec["m2"].numpy(), np.asarray(jrec["m2"]),
                                   **VALUE_TOL)


def test_encode_incomplete_rows_match_jax():
    """``ignore_incomplete`` encodes rows missing a conditioning modality
    from the experts they hold (the prior alone where they hold none)."""
    jmodel, tmodel = _models()
    data, masks, _ = _arrays(True, seed=8)
    key = jax.random.key(9)
    ref = jmodel.encode(JIncompleteDataset(data, masks), cond_mod=["m0", "m1"],
                        rng=key, ignore_incomplete=True)
    tmodel.draw_noise = lambda shape, generator=None: _normal(key, shape)
    with torch.no_grad():
        out = tmodel.encode(IncompleteDataset(data, masks), cond_mod=["m0", "m1"],
                            ignore_incomplete=True)
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
    with pytest.raises(AttributeError, match="incomplete dataset"):
        tmodel.encode(IncompleteDataset(data, masks), cond_mod="m1")


def test_joint_nll_matches_jax():
    jmodel, tmodel = _models()
    data, _, _ = _arrays(False, seed=10)
    key = jax.random.key(11)
    K, chunk = 7, 3                       # chunks of 3, 3 and a remainder of 1
    ref = float(jmodel.compute_joint_nll(data, K=K, batch_size_K=chunk, rng=key))
    keys, shapes = iter([k for k in _chain(key, 3)]), []

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


def _chain(key, n):
    """The keys ``lax.scan`` hands out: the carry split once per chunk."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def test_config_json_round_trip_with_jax(tmp_path):
    kw = _config_kwargs(k=2, warmup=3)
    jcfg, tcfg = JMVAEConfig(**kw), MVAEConfig(**kw)
    assert jcfg.to_dict() == tcfg.to_dict()
    assert MVAEConfig().to_dict() == JMVAEConfig().to_dict()
    jcfg.save_json(str(tmp_path), "model_config")
    assert MVAEConfig.from_json_file(str(tmp_path / "model_config.json")) == tcfg
    tcfg.save_json(str(tmp_path), "port_config")
    with open(tmp_path / "port_config.json") as f:
        assert json.load(f)["name"] == "MVAEConfig"
    assert JMVAEConfig.from_json_file(str(tmp_path / "port_config.json")) == jcfg


def test_two_modalities_draw_no_random_subsets(tmp_path):
    """With two modalities there is no subset of 2 to M-1 modalities: k is
    set to 0, as in the JAX package, and the default nets train and
    reload."""
    dims = {"a": (5,), "b": (1, 2, 3)}
    model = MVAE(MVAEConfig(n_modalities=2, latent_dim=LATENT, input_dims=dims, k=3),
                 seed=3, device="cpu")
    jmodel = JMVAE(JMVAEConfig(n_modalities=2, latent_dim=LATENT, input_dims=dims, k=3))
    assert model.k == jmodel.k == 0 and model.subsets == jmodel.subsets == []
    data = {m: np.random.default_rng(0).uniform(size=(4, *d)).astype(np.float32)
            for m, d in dims.items()}
    out = model(data, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out.loss) and "random_subset_0" not in out.metrics
    model.save(str(tmp_path))
    reloaded = MVAE.load_from_folder(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k
