"""The trainer's bfloat16 ``mixed_precision`` against the JAX package's, on
the CPU at a small size.

The JAX step (``BaseTrainer._build_step_body``'s ``loss_fn``) casts every
float32 leaf of the parameters and of the batch to bfloat16
(``_to_bf16``), runs ``model.loss_function``, takes the loss in float32 and
casts the gradients back to float32. The port's step runs the loss inside
``trainer._train_context()`` (bf16 copies of the parameters swapped in) on
the batch's float leaves in bf16 (``trainer._train_loss``), and the backward
reaches the float32 parameters through the casts. The JAX noise is drawn in
bf16 (``loc.dtype``) and fed through ``draw_noise``.

XLA on the CPU keeps float32 between fused bf16 ops
(``xla_allow_excess_precision``), and torch rounds every op's result to
bf16, so the JAX bf16 loss is not a bit-level reference: each comparison
states its tolerance beside the measured bf16-vs-f32 gap of each package,
which the tests print.
"""

import itertools
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multivae_tpu.ops.pallas_mixture as pm
from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVAE as JMVAE
from multivae_tpu.models import MVAEConfig as JMVAEConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base.base_trainer import _to_bf16
from multivae_tpu_torch.data import IncompleteDataset, batch_from_arrays
from multivae_tpu_torch.models import MMVAE, MVAE, MVTCAE, MMVAEConfig, MVAEConfig, MVTCAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops import mixture as mx
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from torch_parity import LAPLACE_LOW, Recorder, normal, port_model, state_of, uniform

import torch_dp_cases as cases

torch.set_num_threads(2)

DIMS = {"m0": (4,), "m1": (6,), "m2": (1, 3, 3)}
LATENT, HID, B, SEED = 8, 16, 8, 11
M = len(DIMS)
BF16_LAPLACE_LOW = -0.5 + float(jnp.finfo(jnp.bfloat16).eps)
# Port vs JAX in bf16: the two round at other places (XLA keeps float32
# between fused ops), about a bf16 ulp (2^-8) of each term. Losses and
# metrics are sums of 10^2 such terms: within 1e-2 relative (measured
# 2e-5 to 3e-4). Gradients by relative L2 norm: all of them together
# within 5e-2 (measured 5e-3 to 3e-2), each within 1e-1 of its own norm or
# of a tenth of the whole gradient's, whichever is larger: a small
# gradient is a sum of larger terms that cancel, each rounded to bf16
# (measured up to 1.8e-1 of its own norm, for a bias of norm 2e-2 in a
# gradient of norm 1.5). The f32 step draws f32 noise, so the
# bf16-vs-f32 gaps printed beside hold other draws as well as other
# roundings: they are ~1e-3 on the loss in both packages alike, and O(1)
# on single gradients (the port's, printed).
LOSS_RTOL, GRAD_RTOL, GRAD_EACH_RTOL = 1e-2, 5e-2, 1e-1
# every family, port only: the bf16 step's loss within 5% of the f32 one
# (the JAX package's own bound, test_perf_features.py)
FAMILY_RTOL = 0.05


def _bf16_draw(fn, key, shape, *args):
    """``fn(key, shape, bfloat16, *args)`` as a torch bf16 tensor (exact
    through float32): the head of a power-of-two draw, as
    ``torch_parity._draw`` takes it (JAX's partitionable threefry gives
    16-bit draws that property too), so the shapes share compiles."""
    n = math.prod(shape)
    size = max(1024, 1 << (n - 1).bit_length())
    head = np.asarray(fn(key, (size,), jnp.bfloat16, *args).astype(jnp.float32))[:n]
    return torch.from_numpy(head.reshape(tuple(shape))).to(torch.bfloat16)


def bf16_normal(key, shape):
    """``jax.random.normal(key, shape, bfloat16)``: JAX's draw for a bf16
    ``loc`` (``rsample_from_gaussian``, ``dist_rsample``)."""
    return _bf16_draw(jax.random.normal, key, shape)


def bf16_laplace_u(key, shape):
    """JAX's Laplace noise for a bf16 ``loc``: uniform in bf16 on
    [-0.5 + eps(bf16), 0.5)."""
    return _bf16_draw(jax.random.uniform, key, shape, BF16_LAPLACE_LOW, 0.5)


def _rel_l2(ours, ref):
    return (ours.double() - ref.double()).norm().item() / max(ref.double().norm().item(),
                                                              1e-30)


def assert_gradients_close(grads, ref):
    """``GRAD_RTOL`` on all gradients together, ``GRAD_EACH_RTOL`` on each
    (of its norm, or of a tenth of the whole gradient's)."""
    assert set(grads) == set(ref)
    names = sorted(grads)
    whole = torch.cat([ref[n].double().flatten() for n in names])
    assert _rel_l2(torch.cat([grads[n].double().flatten() for n in names]), whole) <= GRAD_RTOL
    for n in names:
        err = (grads[n].double() - ref[n].double()).norm().item()
        scale = max(ref[n].double().norm().item(), 0.1 * whole.norm().item())
        assert err <= GRAD_EACH_RTOL * scale, (n, err, scale)


def jax_step(jmodel, batch, key, step):
    """The JAX trainer's bf16 loss_fn and gradients (``_build_step_body``
    under ``mixed_precision``): the model's output, the float32 gradients
    as a port ``state_dict``, and the float32 loss of the same step (whose
    gap is printed only), in one compile."""
    def loss_fn(params):
        out = jmodel.loss_function(_to_bf16(params), _to_bf16(batch), key, step)
        return out["loss"].astype(jnp.float32), out

    def both(params):
        (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, grads, jmodel.loss_function(params, batch, key, step)["loss"]

    out, grads, loss32 = jax.jit(both)(jmodel.params)
    return (out, state_of(jax.tree.map(lambda g: g.astype(jnp.float32), grads)),
            float(loss32))


def port_step(trainer, batch, info):
    """The port trainer's train step up to the optimizer: its loss and the
    parameters' gradients."""
    trainer.optimizer.zero_grad(set_to_none=True)
    with trainer._train_context():
        out = trainer._train_loss(batch, info, trainer.generator)
        out["loss"].backward()
    return out, {n: p.grad for n, p in trainer.model.named_parameters()}


def _nets(jax_side: bool):
    Cfg, Enc, Dec = ((JAEConfig, JEncoder, JDecoder) if jax_side
                     else (BaseAEConfig, Encoder_VAE_MLP, Decoder_AE_MLP))
    return ({m: Enc(Cfg(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
             for m, d in DIMS.items()},
            {m: Dec(Cfg(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
             for m, d in DIMS.items()})


def _arrays(seed=0, n=B):
    rng = np.random.default_rng(seed)
    data = {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}
    masks = {m: (rng.uniform(size=n) > 0.3).astype(np.float32) for m in DIMS}
    for m in DIMS:
        masks[m][0] = 1.0                     # a complete row
    for m in DIMS:
        data[m][masks[m] == 0] = 0.0
    weights = np.ones(n, np.float32)
    weights[-1] = 0.0                         # a loader padding row
    return data, masks, weights


# --- the three families against the JAX trainer's bf16 step ----------------

def _mvtcae(jax_side):
    enc, dec = _nets(jax_side)
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS, alpha=0.3, beta=1.5,
              decoders_dist={"m0": "normal", "m1": "laplace", "m2": "bernoulli"})
    if jax_side:
        return JMVTCAE(JMVTCAEConfig(**kw), encoders=enc, decoders=dec, seed=0)
    return MVTCAE(MVTCAEConfig(**kw), encoders=enc, decoders=dec, device="cpu")


def _mmvae(jax_side):
    enc, dec = _nets(jax_side)
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS, K=3, learn_prior=True,
              loss="dreg_looser", prior_and_posterior_dist="laplace_with_softmax",
              decoders_dist={"m0": "laplace", "m1": "laplace", "m2": "normal"})
    if jax_side:
        return JMMVAE(JMMVAEConfig(**kw), encoders=enc, decoders=dec, seed=0)
    return MMVAE(MMVAEConfig(**kw), encoders=enc, decoders=dec, device="cpu")


def _mvae(jax_side):
    enc, dec = _nets(jax_side)
    kw = dict(n_modalities=M, latent_dim=LATENT, input_dims=DIMS, k=2, beta=2.5,
              decoders_dist={"m0": "normal", "m1": "bernoulli", "m2": "laplace"})
    if jax_side:
        return JMVAE(JMVAEConfig(**kw), encoders=enc, decoders=dec, seed=0)
    return MVAE(MVAEConfig(**kw), encoders=enc, decoders=dec, device="cpu")


def _mvtcae_draws(key, mixed):
    draw = bf16_normal if mixed else normal
    return {"noise": lambda shape, generator=None: draw(key, shape)}


def _mmvae_draws(key, mixed):
    keys = list(jax.random.split(key, M))

    def noise(shape, generator=None):
        if mixed:
            return bf16_laplace_u(keys.pop(0), shape)
        return uniform(keys.pop(0), shape, LAPLACE_LOW, 0.5)
    return {"noise": noise}


def _mvae_draws(key, mixed):
    """MVAE's loss draws (``test_torch_mvae._JaxDraws``): subset s's noise
    from ``sub_rngs[s]``, the k random subsets from ``choice_rng``."""
    rng, *sub_rngs = jax.random.split(key, 2 + M + 2)
    choice_rng = jax.random.split(rng)[1]

    def one(k, shape):
        return (bf16_normal if mixed else normal)(k, shape)

    return {"noise": lambda shape, generator=None: torch.stack(
                [one(k, shape[1:]) for k in sub_rngs[:shape[0]]]),
            "subsets": lambda n, k, generator=None: torch.tensor(np.asarray(
                jax.random.choice(choice_rng, n, shape=(k,), replace=False)))}


FAMILIES = {"MVTCAE": (_mvtcae, _mvtcae_draws, False),
            "MMVAE_dreg": (_mmvae, _mmvae_draws, False),
            "MVAE": (_mvae, _mvae_draws, True)}


@pytest.fixture(scope="module")
def jax_steps():
    """Each family's JAX model, its bf16 step and its f32 loss, computed
    once."""
    data, masks, weights = _arrays()
    key = jax.random.key(3)
    step = JStepInfo.create(epoch=1, dataset_size=B)
    out = {}
    for name, (build, _, incomplete) in FAMILIES.items():
        jmodel = build(True)
        batch = j_batch_from_arrays(data=data, masks=masks if incomplete else None,
                                    weights=weights)
        out[name] = (jmodel, *jax_step(jmodel, batch, key, step))
    return out


def _port_trainer(tmodel, tmp_path, mixed, **extra):
    data, masks, _ = _arrays()
    from multivae_tpu_torch.data import MultimodalBaseDataset
    ds = IncompleteDataset(data, masks) if tmodel.model_name == "MVAE" else \
        MultimodalBaseDataset(data)
    return BaseTrainer(tmodel, ds, device="cpu", training_config=BaseTrainerConfig(
        output_dir=str(tmp_path), per_device_train_batch_size=B, num_epochs=1,
        mixed_precision=mixed, **extra))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_step_matches_the_jax_trainer(name, jax_steps, tmp_path):
    """The loss, every metric and every gradient of one bf16 train step
    against the JAX trainer's, on the same weights, batch and (bf16)
    draws; the gradients come back float32 on both sides."""
    build, draws_of, incomplete = FAMILIES[name]
    jmodel, jout, jgrads, jloss32 = jax_steps[name]
    data, masks, weights = _arrays()
    batch = batch_from_arrays(data=data, masks=masks if incomplete else None,
                              weights=weights)
    results = {}
    for mixed in (False, True):
        tmodel = port_model(jmodel, build(False))
        trainer = _port_trainer(tmodel, tmp_path / str(mixed), mixed)
        draws = draws_of(jax.random.key(3), mixed)
        tmodel.draw_noise = draws["noise"]
        if "subsets" in draws:
            tmodel.draw_subsets = draws["subsets"]
        results[mixed] = port_step(trainer, batch, StepInfo(epoch=1, dataset_size=B))
    (out, grads), (out32, grads32) = results[True], results[False]
    loss, jloss = out["loss"].item(), float(jout["loss"])
    print(f"{name}: loss bf16 port {loss:.6f} jax {jloss:.6f} (gap "
          f"{abs(loss - jloss) / abs(jloss):.2e}); bf16 vs f32: port "
          f"{abs(loss - out32['loss'].item()) / abs(out32['loss'].item()):.2e}, jax "
          f"{abs(jloss - jloss32) / abs(jloss32):.2e}")
    assert out["loss"].dtype == torch.float32
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["loss_sum"].item(), float(jout["loss_sum"]),
                               rtol=LOSS_RTOL)
    assert set(out.get("metrics", {})) == set(jout.get("metrics", {}))
    for k, v in out.get("metrics", {}).items():
        np.testing.assert_allclose(v.float().item(), float(jout["metrics"][k]),
                                   rtol=LOSS_RTOL, atol=1e-2, err_msg=k)
    def whole(g):
        return torch.cat([g[n].double().flatten() for n in sorted(g)])

    worst = max(_rel_l2(grads[n], jgrads[n]) for n in grads)
    print(f"{name}: gradients rel L2 port vs jax (bf16): all "
          f"{_rel_l2(whole(grads), whole(jgrads)):.2e}, worst one {worst:.2e}; all, bf16 "
          f"vs f32, port: {_rel_l2(whole(grads), whole(grads32)):.2e}")
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_gradients_close(grads, jgrads)
    # the master weights stay float32
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_bf16_microbatched_epoch_matches_the_jax_trainer(tmp_path):
    """``microbatch_steps=2`` in bf16: a 2-epoch curve of MMVAE (DReG) on
    24 rows in batches of 8 against the JAX trainer's with its draws
    (chunk i of step t from ``fold_in(fold_in(key(seed), t), i)``), SGD so
    the weights compare tightly."""
    rng = np.random.default_rng(5)
    data = {m: rng.uniform(size=(24, *d)).astype(np.float32) for m, d in DIMS.items()}
    common = dict(num_epochs=2, learning_rate=1e-2, per_device_train_batch_size=8,
                  seed=SEED, optimizer_cls="SGD", microbatch_steps=2, mixed_precision=True)
    jmodel = _mmvae(True)
    tmodel = port_model(jmodel, _mmvae(False))
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    rec = Recorder()
    from multivae_tpu.data import MultimodalBaseDataset as JDataset
    from multivae_tpu_torch.data import MultimodalBaseDataset
    jt = JTrainer(jmodel, JDataset(data), training_config=JTrainerConfig(
        output_dir=str(tmp_path / "jax"), n_devices=1, **common), callbacks=[rec])
    jt.train()
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data), device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), **common))
    steps = itertools.count()
    chunk_keys = []

    def noise(shape, generator=None):
        if not chunk_keys:
            step = next(steps)
            base = jax.random.fold_in(jax.random.key(SEED), step)
            for i in range(2):
                chunk_keys.extend(jax.random.split(jax.random.fold_in(base, i), M))
        return bf16_laplace_u(chunk_keys.pop(0), shape)

    tmodel.draw_noise = noise
    trainer.train()
    assert next(steps) == 2 * 3
    losses = [h["train_epoch_loss"] for h in trainer.history]
    ref = [log["train_epoch_loss"] for log in rec.logs]
    print(f"microbatched bf16 epoch losses port {losses} jax {ref}")
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
    ref_state = state_of(jt.state.params)
    # SGD: each move is the learning rate times the summed gradients
    assert_gradients_close({n: v - start[n] for n, v in tmodel.state_dict().items()},
                           {n: ref_state[n] - start[n] for n in start})
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())


# --- every family, port only ------------------------------------------------

def _one_step(trainer):
    batch = next(iter(trainer.train_loader)).to(trainer.device)
    out, grads = port_step(trainer, batch, StepInfo(epoch=1, dataset_size=cases.N_TRAIN))
    return out["loss"].item(), grads


@pytest.mark.parametrize("family", list(cases.FAMILIES))
def test_every_family_trains_in_bf16(family, tmp_path):
    """One bf16 step of each of the 14 families: a finite loss within 5% of
    the f32 step's on the same weights and batch; float32 gradients, master
    weights and optimizer state after the optimizer's step; the eval pass
    unchanged, float32, from the f32 trainer's on the same weights."""
    losses = {}
    for mixed in (False, True):
        trainer = cases.trainer_of(family, str(tmp_path / str(mixed)), num_epochs=1,
                                   mixed_precision=mixed, optimizer_cls="Adam",
                                   optimizer_params=None, scheduler_cls=None,
                                   scheduler_params=None)
        losses[mixed], grads = _one_step(trainer)
    print(f"{family}: loss f32 {losses[False]:.6f} bf16 {losses[True]:.6f}")
    assert np.isfinite(losses[True])
    assert losses[True] == pytest.approx(losses[False], rel=FAMILY_RTOL)
    assert any(g is not None for g in grads.values())
    assert all(g.dtype == torch.float32 for g in grads.values() if g is not None)
    trainer.optimizer.step()
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    state = [v for s in trainer.optimizer.state.values() for v in s.values()
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert state and all(v.dtype == torch.float32 for v in state)
    mixed_eval = trainer.eval_step(1)
    trainer.training_config.mixed_precision = False
    assert trainer.eval_step(1) == mixed_eval


# --- steps_per_execution with the device cache ------------------------------

def test_bf16_chunked_epochs_equal_the_step_by_step_loop(tmp_path):
    """``steps_per_execution=4`` over the device cache (eager chunks on the
    CPU) gives the bf16 step-by-step loop's epochs and weights bit for
    bit."""
    runs = {}
    for spe in (1, 4):
        trainer = cases.trainer_of("MVTCAE", str(tmp_path / str(spe)), num_epochs=2,
                                   mixed_precision=True, cache_on_device=True,
                                   steps_per_execution=spe, scheduler_cls=None,
                                   scheduler_params=None)
        trainer.train()
        runs[spe] = ([(h["train_epoch_loss"], h["eval_epoch_loss"]) for h in trainer.history],
                     trainer.model.state_dict())
    assert runs[1][0] == runs[4][0]
    for n, v in runs[1][1].items():
        assert torch.equal(v, runs[4][1][n]), n


# --- the plain mixture in bf16 ----------------------------------------------

@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_mixture_takes_bf16_as_the_xla_composition(dist):
    """The plain version on bf16 inputs against ``mixture_log_density_xla``
    on the same bf16 values: float32 out, bf16 gradients (5e-2 by norm:
    bf16 ops rounded at other places)."""
    rng = np.random.default_rng(0)
    mq, mz, k, b, d = 3, 3, 4, 16, 32
    arrays = [rng.normal(size=(mz, k, b, d)), rng.normal(size=(mq, b, d)),
              rng.uniform(0.5, 1.5, size=(mq, b, d))]
    mask = np.ones((mq, b), np.float32)
    mask[1, :5] = 0.0
    g = rng.normal(size=(mz, k, b)).astype(np.float32)
    leaves = [torch.tensor(a, dtype=torch.float32).bfloat16().requires_grad_()
              for a in arrays]
    tmask = torch.tensor(mask).bfloat16()
    out = mx.mixture_log_density_plain(*leaves, tmask, dist)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    jl = [jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16) for t in leaves]

    def loss(z, m, s):
        o = pm.mixture_log_density_xla(z, m, s, jnp.asarray(mask).astype(jnp.bfloat16), dist)
        return (o * g).sum(), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                   has_aux=True))(*jl)
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    assert all(t.dtype == torch.bfloat16 for t in grads)
    assert all(t.dtype == jnp.bfloat16 for t in jgrads)
    # compiled, XLA keeps the fused terms in float32; the port rounds each
    # term to bf16: a bf16 ulp (2^-8) of the output at most (measured 5e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2 ** -8)
    for gt, gj in zip(grads, jgrads):
        assert _rel_l2(gt.float(), torch.from_numpy(np.asarray(gj.astype(jnp.float32)))) <= 5e-2
    assert (grads[1][1, :5] == 0).all() and (grads[2][1, :5] == 0).all()


def test_bf16_kernel_inputs_are_checked():
    """The CUDA path takes float32 or bfloat16, all four inputs in one dtype:
    bf16 passes the dtype checks (here the CPU tensors then stop at the
    device check); a mixed or other dtype raises before any launch. bf16
    rows go 16 bytes at a time when D is a multiple of 8; the bf16
    launches count under their own names."""
    z = torch.zeros(2, 3, 4, 16, dtype=torch.bfloat16)
    mus = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    mask = torch.ones(2, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mx._check_inputs(z, mus, mus, mask, "laplace")
    with pytest.raises(TypeError, match="one dtype"):
        mx._check_inputs(z, mus.float(), mus, mask, "laplace")
    with pytest.raises(TypeError, match="one dtype"):
        mx._check_inputs(z, mus, mus, mask.float(), "laplace")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mx._check_inputs(z.half(), mus.half(), mus.half(), mask.half(), "laplace")
    t = torch.zeros(64, dtype=torch.bfloat16)
    assert mx._vectorized(16, t) and not mx._vectorized(12, t)
    assert mx._vectorized(12, t.float())
    assert [mx._counter(k, t) for k in ("fwd", "bwd", "bwd_dz")] == [
        "fwd_bf16", "bwd_bf16", "bwd_dz_bf16"]
    assert set(mx.launches) == set(mx.KERNELS)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_bf16_glue_returns_float_out_and_bf16_gradients(monkeypatch, dist):
    """The autograd Function on bf16 inputs, with the launches' plain
    stand-ins: float32 out, float32 logc, gradients in bf16 (what the bf16
    kernels write), against the plain version in float64 on the same bf16
    values."""
    monkeypatch.setattr(mx, "_launch_fwd", mx._fwd_reference)
    monkeypatch.setattr(mx, "_launch_bwd", mx._bwd_reference)
    rng = np.random.default_rng(1)
    z, mus = rng.normal(size=(2, 3, 8, 16)), rng.normal(size=(3, 8, 16))
    sig = rng.uniform(0.5, 1.5, size=(3, 8, 16))
    leaves = [torch.tensor(a, dtype=torch.float32).bfloat16().requires_grad_()
              for a in (z, mus, sig)]
    mask = torch.ones(3, 8, dtype=torch.bfloat16)
    g = torch.tensor(rng.normal(size=(2, 3, 8)), dtype=torch.float32)
    out = mx._MixtureLogDensity.apply(*leaves, mask, dist)
    grads = torch.autograd.grad(out, leaves, g)
    l64 = [t.detach().double().requires_grad_() for t in leaves]
    out64 = mx.mixture_log_density_plain(*l64, mask.double(), dist)
    grads64 = torch.autograd.grad(out64, l64, g.double())
    assert out.dtype == torch.float32 and all(t.dtype == torch.bfloat16 for t in grads)
    np.testing.assert_allclose(out.detach().numpy(), out64.detach().numpy(), rtol=1e-5,
                               atol=1e-4)
    for gt, g64 in zip(grads, grads64):
        # float32 arithmetic, then one bf16 rounding of each entry
        assert (gt.double() - g64).abs().max() <= 4e-3 * g64.abs().max() + 1e-3


# --- the config --------------------------------------------------------------

def test_a_jax_training_config_with_mixed_precision_loads(tmp_path):
    """``mixed_precision`` loads from the JAX package's
    ``training_config.json`` and reaches the trainer."""
    path = os.path.join(tmp_path, "training_config.json")
    JTrainerConfig(output_dir=str(tmp_path), mixed_precision=True).save_json(
        str(tmp_path), "training_config")
    with open(path) as f:
        saved = json.load(f)
    # the fields the port has (the TPU-only ones are refused, see
    # test_torch_device_cache.py), mixed_precision among them
    ported = {k: v for k, v in saved.items() if k in BaseTrainerConfig().to_dict()}
    assert ported["mixed_precision"] is True
    with open(path, "w") as f:
        json.dump(ported, f)
    cfg = BaseTrainerConfig.from_json_file(path)
    assert cfg.mixed_precision is True
    assert BaseTrainerConfig().mixed_precision is False
