"""The port's joint-encoder nets against their Flax modules, on the CPU at
batch 4 with narrow widths: ``MultipleHeadJointEncoder`` over MLP encoders,
over the PolyMNIST conv encoders (``EncoderConvMMNIST_adapted``, and
``EncoderConvMMNIST`` whose Dense reads a flattened conv map) and with
other fusion depths, and ``ConditionalDecoderMLP`` with a vector and a
flattened image conditioning modality.

Weights cross with ``params_from_jax`` as the ``joint_encoder`` / ``decoder``
groups: the fusion ``Dense_i``, the nested ``dict_encoders_<m>`` (with the
encoder rules, the HWC -> CHW row permutation included) and the conditional
decoder's ``Decoder_AE_MLP_0``. Tolerance: outputs are sums of up to 3*3*128
or 2048 float32 products through up to 7 layers, taken in another order by
XLA and by PyTorch: 1e-5 of values of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import default_architectures as jdefault
from multivae_tpu.nn import mmnist as jmmnist
from multivae_tpu_torch.nn import BaseAEConfig, BaseJointEncoder, BaseConditionalDecoder
from multivae_tpu_torch.nn import default_architectures as default
from multivae_tpu_torch.nn import mmnist
from multivae_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

B, LATENT, HID = 4, 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)
POLY = (3, 28, 28)


def _load(net, jparams, group):
    state = params_from_jax({group: jax.tree.map(np.asarray, jparams)})
    net.load_state_dict({k[len(group) + 1:]: v for k, v in state.items()})
    return net


def _mlp_encoders(dims, jax_side):
    if jax_side:
        return {m: jdefault.Encoder_VAE_MLP(JAEConfig(input_dim=d, latent_dim=LATENT),
                                            hidden_dim=HID) for m, d in dims.items()}
    return {m: default.Encoder_VAE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT),
                                       hidden_dim=HID) for m, d in dims.items()}


def _conv_encoders(name, jax_side):
    module = jmmnist if jax_side else mmnist
    cfg = (JAEConfig if jax_side else BaseAEConfig)(latent_dim=LATENT, input_dim=POLY)
    return {m: getattr(module, name)(cfg) for m in ("m0", "m1")}


CASES = {
    "mlp": ({"a": (5,), "b": (1, 3, 3), "c": (7,)}, None, 2),
    "mlp_one_hidden": ({"a": (5,), "b": (1, 3, 3)}, None, 1),
    "mlp_three_hidden": ({"a": (5,), "b": (2, 2)}, None, 3),
    "conv_adapted": ({"m0": POLY, "m1": POLY}, "EncoderConvMMNIST_adapted", 2),
    "conv_flat_dense": ({"m0": POLY, "m1": POLY}, "EncoderConvMMNIST", 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multiple_head_joint_encoder_matches_flax(case):
    dims, conv, n_hidden = CASES[case]
    rng = np.random.default_rng(0)
    x = {m: rng.uniform(size=(B, *d)).astype(np.float32) for m, d in dims.items()}
    if conv:
        jencs, encs = _conv_encoders(conv, True), _conv_encoders(conv, False)
    else:
        jencs, encs = _mlp_encoders(dims, True), _mlp_encoders(dims, False)
    jnet = jdefault.MultipleHeadJointEncoder(dict_encoders=jencs,
                                             args=JAEConfig(latent_dim=LATENT),
                                             hidden_dim=HID, n_hidden_layers=n_hidden)
    jx = {m: jnp.asarray(v) for m, v in x.items()}
    jparams = jnet.init(jax.random.key(1), jx)["params"]
    assert {f"dict_encoders_{m}" for m in dims} <= set(jparams)
    ref = jnet.apply({"params": jparams}, jx)
    net = _load(default.MultipleHeadJointEncoder(encs, BaseAEConfig(latent_dim=LATENT),
                                                 hidden_dim=HID, n_hidden_layers=n_hidden),
                jparams, "joint_encoder")
    assert isinstance(net, BaseJointEncoder) and len(net.dense) == n_hidden + 2
    out = net({m: torch.tensor(v) for m, v in x.items()})
    for key in ("embedding", "log_covariance"):
        assert out[key].shape == (B, LATENT)
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **TOL)


def test_joint_encoder_copies_are_independent_and_seeded():
    """The joint encoder deep-copies the unimodal encoders: no parameter is
    shared with them, and ``reset_parameters`` draws the copies, then the
    fusion layers, from one generator."""
    encs = _mlp_encoders({"a": (5,), "b": (3,)}, False)
    net = default.MultipleHeadJointEncoder(encs, BaseAEConfig(latent_dim=LATENT))
    own = {id(p) for p in net.parameters()}
    assert not own & {id(p) for e in encs.values() for p in e.parameters()}
    again = default.MultipleHeadJointEncoder(encs, BaseAEConfig(latent_dim=LATENT))
    for a in (net, again):
        a.reset_parameters(torch.Generator().manual_seed(3))
    for (name, p), q in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    with torch.no_grad():
        net.dict_encoders["a"].dense[0].weight.add_(1.0)
    assert not torch.equal(net.dict_encoders["a"].dense[0].weight,
                           encs["a"].dense[0].weight)


@pytest.mark.parametrize("cond_dims", [{"c": (6,)}, {"c": (6,), "img": (1, 4, 4)},
                                       {"img": (2, 3, 3)}])
def test_conditional_decoder_matches_flax(cond_dims):
    data_dim = (1, 3, 4)
    rng = np.random.default_rng(2)
    z = rng.normal(size=(B, LATENT)).astype(np.float32)
    cond = {m: rng.uniform(size=(B, *d)).astype(np.float32) for m, d in cond_dims.items()}
    jnet = jdefault.ConditionalDecoderMLP(latent_dim=LATENT, cond_data_dims=cond_dims,
                                          data_dim=data_dim)
    jcond = {m: jnp.asarray(v) for m, v in cond.items()}
    jparams = jnet.init(jax.random.key(3), jnp.asarray(z), jcond)["params"]
    assert set(jparams) == {"Decoder_AE_MLP_0"}
    ref = jnet.apply({"params": jparams}, jnp.asarray(z), jcond)["reconstruction"]
    net = _load(default.ConditionalDecoderMLP(LATENT, data_dim, cond_dims), jparams,
                "decoder")
    assert isinstance(net, BaseConditionalDecoder)
    out = net(torch.tensor(z), {m: torch.tensor(v) for m, v in cond.items()})
    assert out.reconstruction.shape == (B, *data_dim) == ref.shape
    np.testing.assert_allclose(out.reconstruction.detach().numpy(), np.asarray(ref), **TOL)


def test_params_from_jax_refuses_unknown_groups():
    # every group of the JAX package's models is mapped now (MHVAE's blocks
    # and Nexus's top nets since the last two families were ported)
    with pytest.raises(KeyError, match="Unsupported parameter groups"):
        params_from_jax({"ladder": {}})
