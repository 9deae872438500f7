"""The port's PolyMNIST conv nets against their Flax modules, and the
transposed-conv padding forms that ``params_from_jax`` and
``DecoderConvMMNIST`` rely on, on the CPU at batch 4 and latent 8.

Weights cross with ``params_from_jax``: conv kernels are transposed to
OIHW, transposed-conv kernels are also flipped in both spatial axes, and
the Dense layer after a flatten gets its input rows permuted from Flax's HWC
order to torch's CHW order.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp

from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

B, LATENT = 4, 8
# Outputs are sums of up to 3*3*128 or 2048 float32 products taken in
# another order by XLA and by PyTorch, through up to 4 layers: agreement to
# ~1e-6 of values of order 1.
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(module, x, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.key(seed), x)["params"])


def _port_net(cls, jparams, group, **kwargs):
    net = cls(BaseAEConfig(latent_dim=LATENT, input_dim=(3, 28, 28)), **kwargs)
    state = params_from_jax({group: {"x": jparams}})
    prefix = f"{group}.x."
    net.load_state_dict({k[len(prefix):]: v for k, v in state.items()})
    return net


@pytest.mark.parametrize("name,kwargs", [
    ("EncoderConvMMNIST", {}), ("EncoderConvMMNIST", {"bias": True}),
    ("EncoderConvMMNIST_adapted", {})])
def test_conv_encoders_match_flax(name, kwargs):
    x = np.random.default_rng(0).uniform(size=(B, 3, 28, 28)).astype(np.float32)
    jnet = getattr(jmmnist, name)(JAEConfig(latent_dim=LATENT, input_dim=(3, 28, 28)),
                                  **kwargs)
    jparams = _jax_params(jnet, jnp.asarray(x))
    ref = jnet.apply({"params": jparams}, jnp.asarray(x))
    net = _port_net(getattr(mmnist, name), jparams, "encoders", **kwargs)
    out = net(torch.tensor(x))
    for key in ("embedding", "log_covariance"):
        assert out[key].shape == (B, LATENT)
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("lead", [(B,), (3, B)])
def test_conv_decoder_matches_flax(lead):
    z = np.random.default_rng(1).normal(size=(*lead, LATENT)).astype(np.float32)
    jnet = jmmnist.DecoderConvMMNIST(JAEConfig(latent_dim=LATENT, input_dim=(3, 28, 28)))
    jparams = _jax_params(jnet, jnp.zeros((1, LATENT)))
    ref = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(z))["reconstruction"])
    net = _port_net(mmnist.DecoderConvMMNIST, jparams, "decoders")
    out = net(torch.tensor(z))["reconstruction"].detach().numpy()
    assert out.shape == (*lead, 3, 28, 28) == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


def _flax_conv_transpose(x_nchw, kernel, bias, pad):
    layer = fnn.ConvTranspose(kernel.shape[-1], (3, 3), (2, 2), padding=(pad, pad))
    out = layer.apply({"params": {"kernel": kernel, "bias": bias}},
                      jnp.transpose(jnp.asarray(x_nchw), (0, 2, 3, 1)))
    return np.asarray(jnp.transpose(out, (0, 3, 1, 2)))


# (input size, Flax padding (lo, hi), output size) of the decoder's layers
DECONV_CASES = [(4, (1, 1), 7), (7, (2, 1), 14), (14, (2, 1), 28)]


@pytest.mark.parametrize("size,pad,out_size", DECONV_CASES)
def test_flax_conv_transpose_is_a_flipped_torch_conv_transpose(size, pad, out_size):
    """Flax's ConvTranspose with padding (lo, hi) equals torch's
    conv_transpose2d with the kernel flipped in h and w and padding
    k - 1 - lo, then the last lo - hi rows and columns dropped."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, 5, size, size)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    ref = _flax_conv_transpose(x, kernel, bias, pad)
    assert ref.shape[-1] == out_size

    flipped = torch.tensor(kernel[::-1, ::-1].transpose(2, 3, 0, 1).copy())
    out = F.conv_transpose2d(torch.tensor(x), flipped, torch.tensor(bias),
                             stride=2, padding=3 - 1 - pad[0])
    if pad[0] > pad[1]:
        out = out[..., :-1, :-1]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    # the traps: torch's own forms of the same upsampling do not match
    plain = torch.tensor(kernel.transpose(2, 3, 0, 1).copy())
    if pad == (1, 1):
        unflipped = F.conv_transpose2d(torch.tensor(x), plain, torch.tensor(bias),
                                       stride=2, padding=1)
        assert np.abs(unflipped.numpy() - ref).max() > 0.1
    else:
        for w in (plain, flipped):
            torch_form = F.conv_transpose2d(torch.tensor(x), w, torch.tensor(bias),
                                            stride=2, padding=1, output_padding=1)
            assert torch_form.shape == ref.shape
            assert np.abs(torch_form.numpy() - ref).max() > 0.1


def test_flatten_order_permutation_is_needed():
    """Without the HWC -> CHW row permutation of Dense_0 the encoder
    computes another function."""
    x = np.random.default_rng(2).uniform(size=(B, 3, 28, 28)).astype(np.float32)
    jnet = jmmnist.EncoderConvMMNIST(JAEConfig(latent_dim=LATENT, input_dim=(3, 28, 28)))
    jparams = _jax_params(jnet, jnp.asarray(x))
    ref = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(x))["embedding"])
    net = _port_net(mmnist.EncoderConvMMNIST, jparams, "encoders")
    with torch.no_grad():
        net.dense[0].weight.copy_(torch.tensor(jparams["Dense_0"]["kernel"].T.copy()))
        out = net(torch.tensor(x))["embedding"].numpy()
    assert np.abs(out - ref).max() > 1e-3


def test_reset_parameters_is_seeded_with_torch_default_bounds():
    nets = [cls(BaseAEConfig(latent_dim=LATENT)) for cls in
            (mmnist.EncoderConvMMNIST, mmnist.EncoderConvMMNIST_adapted,
             mmnist.DecoderConvMMNIST)]
    again = [type(n)(BaseAEConfig(latent_dim=LATENT)) for n in nets]
    for a, b in zip(nets, again):
        a.reset_parameters(torch.Generator().manual_seed(5))
        b.reset_parameters(torch.Generator().manual_seed(5))
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), name
    dec = nets[2]
    # a transposed conv's fan_in is out_channels * k * k, as torch has it
    bound = 1.0 / np.sqrt(64 * 9)
    w = dec.deconv[0].weight
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
