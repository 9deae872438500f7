"""The port's Nexus against the JAX package's, on the CPU at a small size:
3 modalities on the default MLP nets (bottom codes of 3, 4 and 3, messages
of 6, top latent 4), batch 8, warm-up 2, dropout rate 0.5, the top decoder
of ``m1`` with an adapted variance.

Weights cross with ``params_from_jax``; noise is the JAX package's: the
bottom codes from ``split(b_rng, M)``, the top code from ``j_rng``, and the
forced dropout's three draws (``bernoulli``, ``randint`` and ``uniform`` of
``split(a_rng, 4)[1:]``) through the port's ``draw_dropout``. Compared: the
loss, ``loss_sum``, every metric and every gradient on both aggregation
branches (forced dropout on a complete batch; the mask-weighted mean on an
incomplete one with a row that has no modality and a padding row), inside
the annealing (epoch 1) and past it (epoch ``warmup + 1``); encode, decode
from the bottom codes and through the top decoders, predict; the checks'
errors; save and reload with custom top nets; and a 4-epoch ``BaseTrainer``
curve across ``start_keep_best_epoch`` with the kept weights.
"""

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import Nexus as JNexus
from multivae_tpu.models import NexusConfig as JNexusConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import Nexus, NexusConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import Recorder, assert_same_moves, feed_trainer_noise, normal, state_of

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (2, 3)}
SPECIFIC = {"m0": 3, "m1": 4, "m2": 3}
LATENT, MSG, WARMUP, B, SEED = 4, 6, 2, 8, 5
M = len(DIMS)
# Losses and metrics: sums of 10^2 float32 terms in another order: 1e-5
# relative. Gradients through 2 levels of 512-wide MLPs: 1e-4 relative,
# with an absolute floor of 1e-6 for entries that cancel to ~0.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _config_kwargs(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS,
              modalities_specific_dim=dict(SPECIFIC), msg_dim=MSG, warmup=WARMUP,
              dropout_rate=0.5, top_beta=0.7, bottom_betas={"m0": 0.5, "m1": 1.0, "m2": 2.0},
              gammas={"m0": 3.0, "m1": 1.0, "m2": 0.5}, adapt_top_decoder_variance=["m1"],
              decoders_dist={"m0": "normal", "m1": "laplace", "m2": "bernoulli"},
              decoder_dist_params={"m0": {"scale": 0.5}})
    kw.update(extra)
    return kw


def _port(jmodel, **kw):
    tmodel = Nexus(NexusConfig(**_config_kwargs()), device="cpu", **kw)
    tmodel.load_state_dict(state_of(jmodel.params))
    return tmodel


@pytest.fixture(scope="module")
def jmodel():
    return JNexus(JNexusConfig(**_config_kwargs()), seed=0)


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


def _loss_draws(model, key, n_rows=B):
    """The ``draw_noise`` hook of one loss call on ``key``; sets
    ``model.draw_dropout`` to the JAX dropout draws of that key."""
    _, b_rng, a_rng, j_rng = jax.random.split(key, 4)
    keys = iter([*jax.random.split(b_rng, M), j_rng])
    _, d_rng, s_rng, p_rng = jax.random.split(a_rng, 4)
    drop = torch.tensor(np.asarray(jax.random.bernoulli(d_rng, 0.5, (n_rows,))))
    size = torch.tensor(np.asarray(jax.random.randint(s_rng, (n_rows,), 1, M)))
    scores = torch.tensor(np.asarray(jax.random.uniform(p_rng, (M, n_rows))))

    def dropout(n_mods, rows, generator=None):
        assert (n_mods, rows) == (M, n_rows)
        return drop, size, scores

    model.draw_dropout = dropout
    return lambda shape, generator=None: normal(next(keys), shape)


@pytest.fixture(scope="module")
def jax_losses(jmodel):
    """The jitted JAX value-and-grad of the loss, one per aggregation branch
    (the batch's ``incomplete`` flag is static)."""
    def loss(params, batch, key, step):
        out = jmodel.loss_function(params, batch, key, step)
        return out.loss, out
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("epoch", [1, WARMUP + 1], ids=["annealing", "annealed"])
@pytest.mark.parametrize("incomplete", [False, True], ids=["dropout", "masked"])
def test_loss_metrics_and_every_gradient_match_jax(jmodel, jax_losses, incomplete, epoch):
    tmodel = _port(jmodel)
    data, masks, weights = _arrays(incomplete, seed=epoch)
    key = jax.random.key(epoch)
    batch = j_batch_from_arrays(data=data, masks=masks, weights=weights)
    (_, ref), jgrads = jax_losses(jmodel.params, batch, key,
                                  JStepInfo.create(epoch=epoch, dataset_size=B))
    if not incomplete:   # some rows drop out, some keep every message
        assert 0 < float(ref.metrics["annealing"]) and jmodel.model_config.dropout_rate == 0.5
    tmodel.draw_noise = _loss_draws(tmodel, key)
    out = tmodel.loss_function(batch_from_arrays(data=data, masks=masks, weights=weights),
                               StepInfo(epoch=epoch, dataset_size=B))
    out.loss.backward()
    assert out.metrics["annealing"].item() == min(epoch / WARMUP, 1.0)
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics)
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    unused = {n for n, g in grads.items() if g is None}
    # the top encoders' log-variance heads are never read (a message is an
    # embedding): no gradient in torch, zeros in JAX
    assert unused == {f"top_encoders.{m}.dense.{i}.{p}" for m in DIMS for i in (3,)
                      for p in ("weight", "bias")}
    for name in unused:
        assert not ref_grads[name].any(), name
    for name, g in grads.items():
        if name not in unused:
            assert np.isfinite(g.numpy()).all(), name
            np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                       **GRAD_TOL)


def test_dropout_keeps_a_random_subset_of_the_messages():
    """The ranks of the scores pick ``size`` messages on a dropped row; a
    kept row averages all M."""
    tmodel = Nexus(NexusConfig(**_config_kwargs()), device="cpu")
    msgs = {m: torch.full((3, 2), float(i + 1)) for i, m in enumerate(DIMS)}
    tmodel.draw_dropout = lambda n, rows, generator=None: (
        torch.tensor([True, True, False]), torch.tensor([1, 2, 1]),
        torch.tensor([[0.9, 0.1, 0.5], [0.2, 0.3, 0.5], [0.5, 0.8, 0.5]]))
    agg = tmodel._aggregate_during_training(batch_from_arrays(
        data={m: np.zeros((3, *d), np.float32) for m, d in DIMS.items()}), msgs, None)
    # row 0 keeps the lowest score (m1: 2); row 1 the two lowest (m0, m1);
    # row 2 does not drop out
    np.testing.assert_allclose(agg[:, 0].numpy(), [2.0, 1.5, 2.0])


def _encode_noise(key, n_cond):
    """encode: ``rng, z_rng = split(key)``; the bottom codes from
    ``split(rng, n_cond)`` (the port draws them first), then z."""
    rng, z_rng = jax.random.split(key)
    keys = iter([*jax.random.split(rng, n_cond), z_rng])
    return lambda shape, generator=None: normal(next(keys), shape)


def test_encode_decode_predict_match_jax(jmodel):
    tmodel = _port(jmodel)
    data, _, _ = _arrays(False, seed=6)
    with torch.no_grad():
        for i, (cond, N, flatten, mean) in enumerate(((["m2", "m0"], 3, True, False),
                                                      ("all", 1, False, False),
                                                      ("m1", 2, False, True))):
            key = jax.random.key(10 + i)
            ref = jmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean, rng=key)
            n_cond = len(tmodel._normalize_cond_mod(cond))
            tmodel.draw_noise = _encode_noise(key, n_cond)
            out = tmodel.encode(data, cond_mod=cond, N=N, flatten=flatten,
                                return_mean=mean)
            assert out.one_latent_space and out.cond_mod == ref.cond_mod
            np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), **VALUE_TOL)
            assert set(out.modalities_z) == set(ref.modalities_z)
            for m, v in out.modalities_z.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(ref.modalities_z[m]),
                                           err_msg=m, **VALUE_TOL)
            # the conditioning modalities from their bottom codes, the others
            # through the top decoders; then all through the top decoders
            for bottom in (True, False):
                dec = tmodel.decode(out, use_bottom_z_for_recon=bottom)
                jdec = jmodel.decode(ref, use_bottom_z_for_recon=bottom)
                for m in DIMS:
                    np.testing.assert_allclose(dec[m].numpy(), np.asarray(jdec[m]),
                                               err_msg=f"{cond} {m} {bottom}", **VALUE_TOL)
        key = jax.random.key(20)
        ref = jmodel.predict(data, cond_mod="m1", gen_mod="all", N=2, rng=key)
        tmodel.draw_noise = _encode_noise(key, 1)
        out = tmodel.predict(data, cond_mod="m1", gen_mod="all", N=2)
    for m in DIMS:
        assert out[m].shape == (2, B, *DIMS[m])
        np.testing.assert_allclose(out[m].numpy(), np.asarray(ref[m]), err_msg=m,
                                   **VALUE_TOL)


@pytest.mark.parametrize("bad", ["bottom_betas", "gammas", "adapt", "aggregator", "dims"])
def test_checks_raise_like_jax(bad):
    extra = {"bottom_betas": {"bottom_betas": {"m0": 1.0}},
             "gammas": {"gammas": {"m0": 1.0, "x": 2.0, "m2": 1.0}},
             "adapt": {"adapt_top_decoder_variance": ["m1", "x"]},
             "aggregator": {"aggregator": "sum"},
             "dims": {"modalities_specific_dim": None}}[bad]
    messages = []
    for cls, cfg, kw in ((JNexus, JNexusConfig, {}), (Nexus, NexusConfig, {"device": "cpu"})):
        try:
            config = cfg(**_config_kwargs(**extra))
        except Exception:   # the JAX config validates the aggregator itself
            assert cls is JNexus and bad == "aggregator"
            config = cfg(**_config_kwargs())
            object.__setattr__(config, "aggregator", "sum")
        with pytest.raises(AttributeError) as e:
            cls(config, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_save_and_reload_with_custom_top_nets(tmp_path):
    top_enc = {m: Encoder_VAE_MLP(BaseAEConfig(input_dim=(s,), latent_dim=MSG), hidden_dim=8)
               for m, s in SPECIFIC.items()}
    top_dec = {m: Decoder_AE_MLP(BaseAEConfig(input_dim=(s,), latent_dim=LATENT),
                                 hidden_dim=8) for m, s in SPECIFIC.items()}
    joint = Encoder_VAE_MLP(BaseAEConfig(input_dim=(MSG,), latent_dim=LATENT), hidden_dim=8)
    tmodel = Nexus(NexusConfig(**_config_kwargs()), top_encoders=top_enc,
                   top_decoders=top_dec, joint_encoder=joint, device="cpu")
    assert sorted(tmodel.model_config.custom_architectures) == [
        "joint_encoder", "top_decoders", "top_encoders"]
    assert tmodel.start_keep_best_epoch == WARMUP + 1
    tmodel.save(str(tmp_path))
    loaded = Nexus.load_from_folder(str(tmp_path), device="cpu")
    assert loaded.joint_encoder.dense[0].out_features == 8
    state = tmodel.state_dict()
    assert set(loaded.state_dict()) == set(state)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(AttributeError, match="Top encoders"):
        Nexus(NexusConfig(**_config_kwargs()), top_encoders={m: 1 for m in DIMS},
              device="cpu")
    with pytest.raises(NotImplementedError):
        tmodel.compute_joint_nll(MultimodalBaseDataset(_arrays(False)[0]))


def test_trainer_curve_and_kept_weights_match_jax_trainer(tmp_path):
    """4 epochs of BaseTrainer (Adam 1e-3) on 20 rows in batches of 8 (the
    last one padded) with an 8-row eval set, warm-up 1: epochs 1-2 are in
    the keep-best window (``start_keep_best_epoch`` 2) and kept whatever
    their eval loss, epoch 3 is kept as the first after it, epoch 4 only if
    its eval loss is lower. The same weights, batch order, noise and dropout
    draws as the JAX trainer."""
    jmodel = JNexus(JNexusConfig(**_config_kwargs(warmup=1)), seed=0)
    tmodel = Nexus(NexusConfig(**_config_kwargs(warmup=1)), device="cpu")
    tmodel.load_state_dict(state_of(jmodel.params))
    data, eval_data = _arrays(False, seed=7, n=20)[0], _arrays(False, seed=8)[0]
    common = dict(num_epochs=4, learning_rate=1e-3, per_device_train_batch_size=8,
                  per_device_eval_batch_size=8, seed=SEED, optimizer_cls="Adam")
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JDataset(data), JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common),
                        callbacks=[rec])
    jtrainer.train()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data),
                          MultimodalBaseDataset(eval_data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    assert trainer.start_keep_best_epoch == jtrainer.start_keep_best_epoch == 2
    steps = feed_trainer_noise(trainer, tmodel, lambda key: _loss_draws(tmodel, key), SEED)
    trainer.train()
    assert next(steps) == 4 * 3                 # 4 epochs x 3 steps
    for key in ("train_epoch_loss", "eval_epoch_loss", "train_top_loss",
                "eval_annealing"):
        ours = [h[key] for h in trainer.history]
        ref = [h[key] for h in rec.logs]
        # float32 drift over 12 Adam steps of two implementations
        np.testing.assert_allclose(ours, ref, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(trainer.best_eval_loss, jtrainer.best_eval_loss, rtol=1e-4)
    evals = [h["eval_epoch_loss"] for h in trainer.history]
    assert trainer.best_eval_loss == min(evals[2:])
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, 1e-3)
