"""The port's SVHN nets against their Flax modules (``multivae_tpu/nn/svhn.py``),
and MVTCAE on them against the JAX package's (the model of
``tests/test_benchmark_nets.py:64``), on the CPU at a small size (fBase 8,
latent 8, batch 4).

Weights cross with ``params_from_jax`` (transposed-conv kernels flipped);
the MVTCAE noise is the JAX package's ``jax.random.normal`` of each draw's
key.
"""

import numpy as np
import pytest
import torch

import jax

from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn.svhn import Decoder_VAE_SVHN as JDecoder
from multivae_tpu.nn.svhn import Encoder_VAE_SVHN as JEncoder
from multivae_tpu_torch.data import batch_from_arrays
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.models.base.step import StepInfo
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_VAE_SVHN, Encoder_VAE_SVHN
from multivae_tpu_torch.utils.convert import params_from_jax
from torch_parity import normal, port_model, state_of

torch.set_num_threads(2)

B, LATENT, FBASE = 4, 8, 8
DIM = (3, 32, 32)
# Outputs: sums of up to 4*4*32 float32 products in another order, through
# 4 layers: ~1e-6 of values of order 1.
TOL = dict(rtol=1e-5, atol=1e-5)
# The MVTCAE loss: sums of ~10^4 terms; gradients through 4 conv layers.
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("net,lead", [("encoder", ()), ("decoder", ()),
                                      ("decoder", (3,))], ids=["encoder", "decoder",
                                                               "decoder-N"])
def test_svhn_nets_match_flax(net, lead):
    """The encoder's padded and unpadded 4x4 convs; the decoder's (3, 3) and
    (2, 2) Flax transposed convs, on any leading shape of z."""
    cfg = JAEConfig(input_dim=DIM, latent_dim=LATENT)
    if net == "encoder":
        jnet, x, group = JEncoder(cfg, fBase=FBASE), _inputs(0, (B, *DIM)), "encoders"
        tnet = Encoder_VAE_SVHN(BaseAEConfig(input_dim=DIM, latent_dim=LATENT), fBase=FBASE)
    else:
        jnet, x, group = JDecoder(cfg, fBase=FBASE), _inputs(0, (*lead, B, LATENT)), "decoders"
        tnet = Decoder_VAE_SVHN(BaseAEConfig(input_dim=DIM, latent_dim=LATENT), fBase=FBASE)
    params = jax.tree.map(np.asarray, jax.jit(jnet.init)(jax.random.key(1), x)["params"])
    state = params_from_jax({group: {"x": params}})
    tnet.load_state_dict({k[len(group) + 3:]: v for k, v in state.items()})
    ref = jax.jit(jnet.apply)({"params": params}, x)
    with torch.no_grad():
        out = tnet(torch.tensor(x))
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert tuple(out[k].shape) == v.shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(v), err_msg=k, **TOL)


def test_mvtcae_on_svhn_nets_matches_jax():
    """MVTCAE on two 3x32x32 modalities with the SVHN nets: the loss, the
    metrics and every gradient; then encode."""
    dims = {"svhn": DIM, "mnist": DIM}
    jcfg = JAEConfig(input_dim=DIM, latent_dim=LATENT)
    tcfg = BaseAEConfig(input_dim=DIM, latent_dim=LATENT)
    config = dict(n_modalities=2, latent_dim=LATENT, input_dims=dims)
    jmodel = JMVTCAE(JMVTCAEConfig(**config),
                     encoders={m: JEncoder(jcfg, fBase=FBASE) for m in dims},
                     decoders={m: JDecoder(jcfg, fBase=FBASE) for m in dims})
    tmodel = port_model(jmodel, MVTCAE(
        MVTCAEConfig(**config), encoders={m: Encoder_VAE_SVHN(tcfg, FBASE) for m in dims},
        decoders={m: Decoder_VAE_SVHN(tcfg, FBASE) for m in dims}, device="cpu"))
    data = {m: _inputs(i + 2, (B, *DIM)) for i, m in enumerate(dims)}
    key = jax.random.key(3)

    def loss(params):
        out = jmodel.loss_function(params, j_batch_from_arrays(data=data), key,
                                   JStepInfo.create(epoch=1, dataset_size=B))
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    tmodel.draw_noise = lambda shape, generator=None: normal(key, shape)
    out = tmodel.loss_function(batch_from_arrays(data=data), StepInfo(epoch=1,
                                                                      dataset_size=B))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    for name, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[name]), err_msg=name,
                                   **LOSS_TOL)
    ref_grads = state_of(jgrads)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    with torch.no_grad():
        enc = tmodel.encode(data, cond_mod="svhn", return_mean=True)
    ref_enc = jmodel.encode(data, cond_mod="svhn", return_mean=True, rng=key)
    np.testing.assert_allclose(enc.z.numpy(), np.asarray(ref_enc.z), **TOL)
