"""The port's microbatched steps (``ops/microbatch.py`` and the trainer's
``microbatch_steps``) against the JAX package's, on the CPU at a small
size: MMVAE+ (K=3, IWAE) on the multi-latent MLP nets, 3 modalities,
latent 8, private 4, batch 8 with incomplete masks and a padding row.

The JAX package gives chunk i the key ``fold_in(rng, i)``; the port draws
each chunk's noise when its loss runs, in chunk order, and the tests feed
it the JAX draws of that key (the u and w noise per modality, then one
prior draw per recon modality) through ``draw_noise``. Compared: the loss,
``loss_sum`` and every gradient of ``microbatched_value_and_grad`` at 2 and
4 chunks (the tolerances of ``test_torch_mmvaeplus.py``), one chunk against
the plain step, a 3-epoch trainer curve with ``microbatch_steps=2``, and
the refusals.
"""

import itertools

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MMVAEPlus as JMMVAEPlus
from multivae_tpu.models import MMVAEPlusConfig as JMMVAEPlusConfig
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.ops.microbatch import microbatched_value_and_grad
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import IncompleteDataset, MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.models import MMVAEPlus, MMVAEPlusConfig, MVTCAE, MVTCAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.ops.microbatch import microbatched_backward, split_batch
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import LAPLACE_LOW, Recorder, assert_same_moves, port_model, state_of, uniform

torch.set_num_threads(2)

DIMS = {"m0": (5,), "m1": (6,), "m2": (1, 2, 2)}
LATENT, STYLE, HID, B, SEED, LR = 8, 4, 16, 8, 11, 1e-3
M = len(DIMS)
# as in test_torch_mmvaeplus.py: sums of 10^2-10^3 float32 terms in another
# order; gradients through the IWAE weights exp(lw - logsumexp lw)
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5


def _config(**extra):
    kw = dict(n_modalities=M, latent_dim=LATENT, modalities_specific_dim=STYLE,
              input_dims=DIMS, K=3, loss="iwae_looser", beta=2.5,
              prior_and_posterior_dist="laplace_with_softmax", learn_modality_prior=True,
              reconstruction_option="joint_prior",
              decoders_dist={"m0": "laplace", "m1": "normal", "m2": "laplace"},
              decoder_dist_params={"m0": {"scale": 0.75}, "m2": {"scale": 0.75}})
    kw.update(extra)
    return kw


def _nets(ml, Cfg):
    enc = {m: ml.Encoder_VAE_MLP_Style(Cfg(input_dim=d, latent_dim=LATENT, style_dim=STYLE),
                                       hidden_dim=HID) for m, d in DIMS.items()}
    dec = {m: ml.Decoder_AE_MLP(Cfg(input_dim=d, latent_dim=LATENT + STYLE), hidden_dim=HID)
           for m, d in DIMS.items()}
    return enc, dec


def _models(**extra):
    enc, dec = _nets(jdefault, JAEConfig)
    jmodel = JMMVAEPlus(JMMVAEPlusConfig(**_config(**extra)), encoders=enc, decoders=dec,
                        seed=0)
    enc, dec = _nets(default, BaseAEConfig)
    tmodel = MMVAEPlus(MMVAEPlusConfig(**_config(**extra)), encoders=enc, decoders=dec,
                       device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in DIMS}
    for m in DIMS:
        masks[m][0] = 1.0                          # a complete row
    masks["m0"][1], masks["m1"][1], masks["m2"][1] = 1.0, 0.0, 0.0
    for m in DIMS:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0                              # a loader padding row
    return data, masks, weights


def _loss_keys(rng):
    """The keys of one MMVAE+ ``loss_function`` call: u and w of each
    modality, then one prior draw per recon modality."""
    _, s_rng, r_rng = jax.random.split(rng, 3)
    return list(jax.random.split(s_rng, 2 * M)) + list(jax.random.split(r_rng, M))


def _feed(tmodel, key):
    """Make ``tmodel``'s next loss draw the JAX draws of ``key``; returns
    the queue of keys it pops."""
    keys = _loss_keys(key)
    tmodel.draw_noise = lambda shape, generator=None: uniform(keys.pop(0), shape,
                                                              LAPLACE_LOW, 0.5)
    return keys


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatched_loss_and_gradients_match_jax(n_micro):
    jmodel, tmodel = _models()
    data, masks, weights = _arrays()
    key = jax.random.key(2)
    step = JStepInfo.create(epoch=1, dataset_size=B)

    def chunk_loss(params, batch, rng):
        out = jmodel.loss_function(params, batch, rng, step)
        return out.loss, {"loss_sum": out.loss_sum}

    (ref_loss, aux), jgrads = jax.jit(microbatched_value_and_grad(
        chunk_loss, n_micro, has_aux=True))(
            jmodel.params, j_batch_from_arrays(data=data, masks=masks, weights=weights), key)
    ref_grads = state_of(jgrads)

    chunks = itertools.count()
    queues = []

    def loss_fn(chunk):
        assert chunk.n_samples == B // n_micro
        queues.append(_feed(tmodel, jax.random.fold_in(key, next(chunks))))
        return tmodel.loss_function(chunk, StepInfo(epoch=1, dataset_size=B))

    out = microbatched_backward(loss_fn, batch_from_arrays(data=data, masks=masks,
                                                           weights=weights), n_micro)
    assert next(chunks) == n_micro and not any(queues)
    np.testing.assert_allclose(out.loss.item(), float(ref_loss), **LOSS_TOL)
    # the JAX helper means the aux tree over the chunks; the sum is n times it
    np.testing.assert_allclose(out.loss_sum.item(), float(aux["loss_sum"]) * n_micro,
                               **LOSS_TOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters() if p.grad is not None}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * np.abs(ref).max())


def test_one_chunk_is_the_plain_step():
    """``microbatch_steps=1`` runs the batch's loss and backward once: the
    same loss and gradients, bit for bit, as the plain step."""
    _, tmodel = _models()
    data, masks, weights = _arrays(seed=3)
    key = jax.random.key(4)
    results = []
    for micro in (False, True):
        tmodel.zero_grad(set_to_none=True)
        _feed(tmodel, key)
        batch = batch_from_arrays(data=data, masks=masks, weights=weights)
        if micro:
            out = microbatched_backward(lambda b: tmodel.loss_function(b), batch, 1)
        else:
            out = tmodel.loss_function(batch)
            out.loss.backward()
        results.append((out.loss.item(), out.loss_sum.item(),
                        {n: p.grad.clone() for n, p in tmodel.named_parameters()}))
    (l0, s0, g0), (l1, s1, g1) = results
    assert (l0, s0) == (l1, s1)
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name


def test_split_batch_keeps_rows_in_order():
    data, masks, weights = _arrays(seed=5)
    batch = batch_from_arrays(data=data, masks=masks, weights=weights, labels=np.arange(B))
    chunks = split_batch(batch, 4)
    assert [c.labels.tolist() for c in chunks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(c.incomplete for c in chunks)
    assert torch.equal(torch.cat([c.data["m2"] for c in chunks]), batch.data["m2"])
    assert torch.equal(torch.cat([c.weights for c in chunks]), batch.weights)
    with pytest.raises(ValueError, match="not divisible"):
        split_batch(batch, 3)


def test_trainer_curve_with_microbatch_matches_jax_trainer(tmp_path):
    """3 epochs of ``microbatch_steps=2`` (Adam 1e-3) on 20 incomplete rows
    in batches of 8 (the last one padded) against the JAX trainer: chunk i
    of step s draws from ``fold_in(fold_in(key(seed), s), i)``."""
    data, masks, _ = _arrays(seed=6, n=20)
    common = dict(num_epochs=3, learning_rate=LR, per_device_train_batch_size=B,
                  seed=SEED, optimizer_cls="Adam", microbatch_steps=2)
    jmodel, tmodel = _models()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JIncompleteDataset(data, masks), callbacks=[rec],
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, **common))
    jtrainer.train()
    trainer = BaseTrainer(tmodel, IncompleteDataset(data, masks), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    calls = itertools.count()

    def loss_function(batch, step=None, generator=None):
        s, i = divmod(next(calls), 2)
        _feed(tmodel, jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), s), i))
        assert batch.n_samples == B // 2
        return MMVAEPlus.loss_function(tmodel, batch, step, generator)

    tmodel.loss_function = loss_function
    trainer.train()
    assert next(calls) == 3 * 3 * 2          # 3 epochs x 3 steps x 2 chunks
    ours = [h["train_epoch_loss"] for h in trainer.history]
    # float32 drift over 9 Adam steps of two implementations
    np.testing.assert_allclose(ours, [h["train_epoch_loss"] for h in rec.logs], rtol=1e-4)
    assert_same_moves(tmodel.state_dict(), state_of(jtrainer.state.params), start, LR)


@pytest.mark.parametrize("case", ["not_a_sum", "indivisible", "zero"])
def test_refusals_match_jax(tmp_path, case):
    """A model whose loss is not a sum over rows (MVTCAE), a batch that the
    chunk count does not divide, and a chunk count below 1: both packages
    refuse with the same message."""
    if case == "zero":
        with pytest.raises(AttributeError) as jerr:
            JTrainerConfig(microbatch_steps=0)
        with pytest.raises(AttributeError) as err:
            BaseTrainerConfig(microbatch_steps=0)
        assert str(err.value) == str(jerr.value)
        return
    data, _, _ = _arrays(seed=7, n=16)
    kw = dict(per_device_train_batch_size=B, microbatch_steps=2 if case == "not_a_sum" else 3)
    if case == "not_a_sum":
        cfg = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS)
        jmodel, tmodel = JMVTCAE(JMVTCAEConfig(**cfg)), MVTCAE(MVTCAEConfig(**cfg), device="cpu")
        assert not getattr(tmodel, "loss_is_sum", False)
    else:
        jmodel, tmodel = _models()
        assert tmodel.loss_is_sum
    with pytest.raises(AttributeError) as jerr:
        JTrainer(jmodel, JDataset(data), training_config=JTrainerConfig(
            output_dir=str(tmp_path / "jax"), n_devices=1, **kw))
    with pytest.raises(AttributeError) as err:
        BaseTrainer(tmodel, MultimodalBaseDataset(data), device="cpu",
                    training_config=BaseTrainerConfig(output_dir=str(tmp_path / "t"), **kw))
    assert str(err.value) == str(jerr.value)
