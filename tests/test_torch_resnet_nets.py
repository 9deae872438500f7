"""The port's resnet PolyMNIST nets, the multi-latent conv encoder and the
multi-latent MLP nets against their Flax modules, on the CPU at batch 4
with narrow widths (``nf=8, nf_max=16``, latent 8, private 4).

Weights cross with ``params_from_jax``, which maps ``ResnetBlock_i/Conv_j``
inside a net and permutes the rows of every Dense that reads a flattened
NHWC map. Tolerance: outputs are sums of up to 3*3*16 or 7*7*16 float32
products through up to 9 convolutions, taken in another order by XLA and
by PyTorch: 1e-5 of values of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu_torch.nn import BaseAEConfig, BaseMultilatentEncoder
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

B, LATENT, STYLE, NF, NF_MAX = 4, 8, 4, 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = ("embedding", "log_covariance", "style_embedding", "style_log_covariance")


def _images(seed=0):
    return np.random.default_rng(seed).uniform(size=(B, 3, 28, 28)).astype(np.float32)


def _init(module, x, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.key(seed), x)["params"])


def _load(net, jparams, group):
    state = params_from_jax({group: {"x": jparams}})
    prefix = f"{group}.x."
    net.load_state_dict({k[len(prefix):]: v for k, v in state.items()})
    return net


def _nhwc(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 3, 1))


def _nchw(x):
    return np.asarray(jnp.transpose(x, (0, 3, 1, 2)))


@pytest.mark.parametrize("c_in,c_out", [(8, 8), (8, 16), (16, 8)])
def test_resnet_block_matches_flax(c_in, c_out):
    x = np.random.default_rng(c_in + c_out).normal(size=(B, c_in, 7, 7)).astype(np.float32)
    jblock = jmmnist.ResnetBlock(c_in, c_out)
    jparams = _init(jblock, _nhwc(x))
    assert set(jparams) == ({"Conv_0", "Conv_1", "Conv_2"} if c_in != c_out
                            else {"Conv_0", "Conv_1"})
    assert "bias" not in jparams.get("Conv_2", {})
    ref = _nchw(jblock.apply({"params": jparams}, _nhwc(x)))
    state = params_from_jax({"decoders": {"x": {"ResnetBlock_0": jparams}}})
    block = mmnist.ResnetBlock(c_in, c_out)
    block.load_state_dict({k[len("decoders.x.blocks.0."):]: v for k, v in state.items()})
    out = block(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_pool_and_upsample_match_flax():
    x = np.random.default_rng(1).normal(size=(B, 5, 7, 7)).astype(np.float32)
    pooled = mmnist.avg_pool_3_2_1(torch.tensor(x)).numpy()
    ref = _nchw(jmmnist._avg_pool_3_2_1(_nhwc(x)))
    assert pooled.shape == ref.shape == (B, 5, 4, 4)   # odd size: padding counted
    np.testing.assert_allclose(pooled, ref, **TOL)
    up = mmnist.upsample_nearest_2x(torch.tensor(x)).numpy()
    ref = _nchw(jmmnist._upsample_nearest_2x(_nhwc(x)))
    assert up.shape == (B, 5, 14, 14)
    np.testing.assert_array_equal(up, ref)


def _resnet_encoder(lib, private):
    ns = jmmnist if lib == "jax" else mmnist
    return ns.EncoderResnetMMNIST(private_latent_dim=private, shared_latent_dim=LATENT,
                                  nf=NF, nf_max=NF_MAX)


@pytest.mark.parametrize("private", [STYLE, 0])
def test_resnet_encoder_matches_flax(private):
    x = _images()
    jnet = _resnet_encoder("jax", private)
    jparams = _init(jnet, jnp.asarray(x))
    n_blocks = 6 if private else 3
    assert set(jparams) == ({f"Conv_{i}" for i in range(n_blocks // 3)}
                            | {f"ResnetBlock_{i}" for i in range(n_blocks)}
                            | {f"Dense_{i}" for i in range(2 * n_blocks // 3)})
    ref = jnet.apply({"params": jparams}, jnp.asarray(x))
    net = _load(_resnet_encoder("torch", private), jparams, "encoders")
    assert isinstance(net, BaseMultilatentEncoder)
    out = net(torch.tensor(x))
    heads = HEADS if private else HEADS[:2]
    assert set(out.keys()) == set(ref.keys()) == set(heads)
    for key in heads:
        assert out[key].shape == (B, LATENT if "style" not in key else private)
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_every_resnet_encoder_head_needs_the_flatten_permutation():
    """All four heads read a flattened (7, 7, C) map: loading any one of them
    without the HWC -> CHW row permutation changes that head's output."""
    x = _images(2)
    jnet = _resnet_encoder("jax", STYLE)
    jparams = _init(jnet, jnp.asarray(x))
    ref = jnet.apply({"params": jparams}, jnp.asarray(x))
    net = _load(_resnet_encoder("torch", STYLE), jparams, "encoders")
    channels = min(NF * 4, NF_MAX)
    for i, key in enumerate(HEADS):
        kernel = jparams[f"Dense_{i}"]["kernel"]
        assert kernel.shape[0] == 7 * 7 * channels
        permuted = net.dense[i].weight.detach().clone()
        assert not torch.equal(permuted, torch.tensor(kernel.T.copy()))
        with torch.no_grad():
            net.dense[i].weight.copy_(torch.tensor(kernel.T.copy()))
            wrong = net(torch.tensor(x))[key].numpy()
            net.dense[i].weight.copy_(permuted)
        assert np.abs(wrong - np.asarray(ref[key])).max() > 1e-3, key


@pytest.mark.parametrize("lead", [(B,), (2, 3)])
def test_resnet_decoder_matches_flax_without_permutation(lead):
    z = np.random.default_rng(3).normal(size=(*lead, LATENT + STYLE)).astype(np.float32)
    jnet = jmmnist.DecoderResnetMMNIST(latent_dim=LATENT + STYLE, nf=NF, nf_max=NF_MAX)
    jparams = _init(jnet, jnp.zeros((1, LATENT + STYLE)))
    ref = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(z))["reconstruction"])
    net = _load(mmnist.DecoderResnetMMNIST(LATENT + STYLE, nf=NF, nf_max=NF_MAX),
                jparams, "decoders")
    # the decoder reshapes channels-first in Flax too: Dense_0 is only transposed
    assert torch.equal(net.dense[0].weight, torch.tensor(jparams["Dense_0"]["kernel"].T.copy()))
    out = net(torch.tensor(z))["reconstruction"].detach().numpy()
    assert out.shape == (*lead, 3, 28, 28) == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("style_dim", [STYLE, 0])
def test_multilatent_conv_encoder_matches_flax(style_dim):
    x = _images(4)
    jnet = jmmnist.EncoderConvMMNIST_multilatents(
        JAEConfig(latent_dim=LATENT, style_dim=style_dim, input_dim=(3, 28, 28)))
    jparams = _init(jnet, jnp.asarray(x))
    ref = jnet.apply({"params": jparams}, jnp.asarray(x))
    net = _load(mmnist.EncoderConvMMNIST_multilatents(
        BaseAEConfig(latent_dim=LATENT, style_dim=style_dim, input_dim=(3, 28, 28))),
        jparams, "encoders")
    out = net(torch.tensor(x))
    assert set(out.keys()) == set(ref.keys())
    for key in ref.keys():
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_style_mlp_encoder_and_multilatent_dicts_match_flax():
    dims, mods = {"a": (6,), "b": (1, 3, 3)}, {"a": 3, "b": 5}
    jenc = jdefault.BaseDictEncoders_MultiLatents(dims, LATENT, mods)
    jdec = jdefault.BaseDictDecodersMultiLatents(dims, LATENT, mods)
    enc = default.BaseDictEncoders_MultiLatents(dims, LATENT, mods)
    dec = default.BaseDictDecodersMultiLatents(dims, LATENT, mods)
    rng = np.random.default_rng(5)
    for m, d in dims.items():
        x = rng.normal(size=(B, *d)).astype(np.float32)
        jparams = _init(jenc[m], jnp.asarray(x))
        ref = jenc[m].apply({"params": jparams}, jnp.asarray(x))
        out = _load(enc[m], jparams, "encoders")(torch.tensor(x))
        assert out["style_embedding"].shape == (B, mods[m])
        for key in HEADS:
            np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                       err_msg=f"{m} {key}", **TOL)
        z = rng.normal(size=(2, B, LATENT + mods[m])).astype(np.float32)
        jparams = _init(jdec[m], jnp.zeros((1, LATENT + mods[m])))
        ref = jdec[m].apply({"params": jparams}, jnp.asarray(z))["reconstruction"]
        out = _load(dec[m], jparams, "decoders")(torch.tensor(z))["reconstruction"]
        assert out.shape == (2, B, *d)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_reset_parameters_is_seeded():
    nets = [lambda: mmnist.EncoderResnetMMNIST(STYLE, LATENT, nf=NF, nf_max=NF_MAX),
            lambda: mmnist.DecoderResnetMMNIST(LATENT + STYLE, nf=NF, nf_max=NF_MAX),
            lambda: mmnist.EncoderConvMMNIST_multilatents(
                BaseAEConfig(latent_dim=LATENT, style_dim=STYLE)),
            lambda: default.Encoder_VAE_MLP_Style(
                BaseAEConfig(input_dim=(6,), latent_dim=LATENT, style_dim=STYLE))]
    for make in nets:
        a, b = make(), make()
        a.reset_parameters(torch.Generator().manual_seed(5))
        b.reset_parameters(torch.Generator().manual_seed(5))
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), name
