"""The port's CUB nets (``multivae_tpu_torch/nn/cub.py``) against the Flax
modules, and MVTCAE on them with a token-dict text modality, on the CPU at
narrow widths: text of 12 tokens (embed 8, 2 heads, feed-forward 6, 2
layers), the resnet image nets at ``nfilter=8, nfilter_max=16``, latent 4.

Weights cross with ``params_from_jax`` (the attention's per-head kernels,
``Embed``, ``LayerNorm`` and ``PreActResnetBlock_i``). MVTCAE runs on 8
rows of a ``CUB(output_type="tokens")`` built from files written here, the
same rows in both packages; its Gaussian draws are the JAX package's, fed
through ``draw_noise``.

Tolerances: net outputs are float32 sums of up to 3*3*16 products through
up to 7 convolutions, or through LayerNorms whose variance XLA and PyTorch
compute in another way: 2e-5 of values of order 1. The loss and metrics
are sums of 10^4 terms: 1e-5 relative (atol 1e-4). Gradients: 1e-4
relative, with an absolute floor of 1e-3 of the tensor's largest entry and
at least 1e-5. Most tensors agree to ~4e-6 of their largest entry; the
floor is for two cases. The image decoder's last bias gradient is a sum of
8*3*64*64 Laplace signs, and a pixel within float32 rounding of its target
flips one (2e-4 of its largest entry seen). The attention's key biases
have an exact zero gradient (a logit added to a whole row leaves the
softmax as it is), and both packages leave ~2e-6 of float32 noise there.
"""

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.data.datasets import CUB as JCUB
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.models.base.step import StepInfo as JStepInfo
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import cub as jcub
from multivae_tpu_torch.data import batch_from_arrays
from multivae_tpu_torch.data.datasets import CUB
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn import cub
from multivae_tpu_torch.tools.dataset_files import write_cub
from multivae_tpu_torch.utils.convert import params_from_jax
from test_torch_mvtcae import _JaxNoise
from torch_parity import compiled_init

torch.set_num_threads(2)

B, L, E, HEADS, FF, LAYERS, LATENT, NF, NF_MAX = 4, 12, 8, 2, 6, 2, 4, 8, 16
NET_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_RTOL, GRAD_FLOOR, GRAD_ATOL = 1e-4, 1e-3, 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)


def _init(module, *args, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.key(seed), *args)["params"])


def _load(net, jparams, group="encoders"):
    state = params_from_jax({group: {"x": jparams}})
    prefix = f"{group}.x."
    net.load_state_dict({k[len(prefix):]: v for k, v in state.items()})
    return net


def _text(seed, vocab=20, lengths=(12, 7, 3, 1)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (len(lengths), L)).astype(np.int64)
    mask = (np.arange(L)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return tokens, mask


def _nhwc(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 3, 1))


def _nchw(x):
    return np.asarray(jnp.transpose(x, (0, 3, 1, 2)))


def test_transformer_layer_matches_flax_with_padding():
    """Per-head attention with padded keys, both LayerNorms (epsilon 1e-6)
    and the feed-forward, against Flax; the rows hold 12, 7, 3 and 1 real
    tokens. Changing the embedding at padded positions must leave the
    outputs at real positions as they were, in both."""
    tokens, mask = _text(0)
    x = np.random.default_rng(1).normal(size=(B, L, E)).astype(np.float32)
    jlayer = jcub.TransformerEncoderLayer(E, HEADS, FF)
    jparams = _init(jlayer, x, mask)
    state = params_from_jax({"encoders": {"x": {"TransformerEncoderLayer_0": jparams}}})
    layer = cub.TransformerEncoderLayer(E, HEADS, FF)
    layer.load_state_dict({k[len("encoders.x.layers.0."):]: v for k, v in state.items()})
    assert layer.norm[0].eps == 1e-6
    ref = np.asarray(jlayer.apply({"params": jparams}, x, mask))
    out = layer(torch.tensor(x), torch.tensor(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, **NET_TOL)

    x2 = x.copy()
    x2[mask == 0] += 3.0
    ref2 = np.asarray(jlayer.apply({"params": jparams}, x2, mask))
    out2 = layer(torch.tensor(x2), torch.tensor(mask)).detach().numpy()
    real = mask == 1
    np.testing.assert_allclose(out2[real], out[real], **NET_TOL)
    np.testing.assert_allclose(ref2[real], ref[real], **NET_TOL)
    np.testing.assert_allclose(out2, ref2, **NET_TOL)


def test_text_encoder_and_decoder_match_flax():
    tokens, mask = _text(2)
    inputs = {"tokens": tokens, "padding_mask": mask}
    jenc = jcub.CubTextEncoder(latent_dim=LATENT, max_sentence_length=L, ntokens=20,
                               embed_size=E, nhead=HEADS, ff_size=FF, n_layers=LAYERS)
    jparams = _init(jenc, jax.tree.map(jnp.asarray, inputs))
    enc = _load(cub.CubTextEncoder(LATENT, L, 20, embed_size=E, nhead=HEADS, ff_size=FF,
                                   n_layers=LAYERS), jparams)
    ref = jenc.apply({"params": jparams}, jax.tree.map(jnp.asarray, inputs))
    out = enc({k: torch.tensor(v) for k, v in inputs.items()})
    for key in ("embedding", "log_covariance", "transformer_output"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **NET_TOL)
    # a padded token's id does not reach the heads
    tokens2 = tokens.copy()
    tokens2[3, 5] = 19
    out2 = enc({"tokens": torch.tensor(tokens2), "padding_mask": torch.tensor(mask)})
    np.testing.assert_allclose(out2["transformer_output"][3, :1].detach().numpy(),
                               out["transformer_output"][3, :1].detach().numpy(), **NET_TOL)

    jdec = jcub.CubTextDecoderMLP(JAEConfig(latent_dim=LATENT, input_dim=(L, 20)))
    z = np.random.default_rng(3).normal(size=(2, B, LATENT)).astype(np.float32)
    jparams = _init(jdec, z)
    dec = _load(cub.CubTextDecoderMLP(BaseAEConfig(latent_dim=LATENT, input_dim=(L, 20))),
                jparams, "decoders")
    ref = np.asarray(jdec.apply({"params": jparams}, z).reconstruction)
    out = dec(torch.tensor(z)).reconstruction.detach().numpy()
    assert out.shape == ref.shape == (2, B, L, 20)
    np.testing.assert_allclose(out, ref, **NET_TOL)


@pytest.mark.parametrize("fin,fout", [(8, 8), (8, 16), (16, 8)])
def test_preact_resnet_block_matches_flax(fin, fout):
    x = np.random.default_rng(fin + fout).normal(size=(B, fin, 9, 9)).astype(np.float32)
    jblock = jcub.PreActResnetBlock(fin, fout)
    jparams = _init(jblock, _nhwc(x))
    state = params_from_jax({"decoders": {"x": {"PreActResnetBlock_0": jparams}}})
    block = cub.PreActResnetBlock(fin, fout)
    block.load_state_dict({k[len("decoders.x.blocks.0."):]: v for k, v in state.items()})
    ref = _nchw(jblock.apply({"params": jparams}, _nhwc(x)))
    np.testing.assert_allclose(block(torch.tensor(x)).detach().numpy(), ref, **NET_TOL)


def test_resnet_encoder_and_decoder_match_flax():
    """The encoder's heads read the flattened (C, 16, 16) map: their rows are
    permuted from Flax's (h, w, c) order; the decoder reshapes channels
    first, as Flax's does."""
    x = np.random.default_rng(4).uniform(size=(B, 3, 64, 64)).astype(np.float32)
    jenc = jcub.CUB_Resnet_Encoder(latent_dim=LATENT, nfilter=NF, nfilter_max=NF_MAX)
    jparams = _init(jenc, x)
    enc = _load(cub.CUB_Resnet_Encoder(LATENT, nfilter=NF, nfilter_max=NF_MAX), jparams)
    ref = jenc.apply({"params": jparams}, x)
    out = enc(torch.tensor(x))
    for key in ("embedding", "log_covariance"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **NET_TOL)

    z = np.random.default_rng(5).normal(size=(2, B, LATENT)).astype(np.float32)
    jdec = jcub.CUB_Resnet_Decoder(latent_dim=LATENT, nfilter=NF, nfilter_max=NF_MAX)
    jparams = _init(jdec, z)
    dec = _load(cub.CUB_Resnet_Decoder(LATENT, nfilter=NF, nfilter_max=NF_MAX), jparams,
                "decoders")
    ref = np.asarray(jdec.apply({"params": jparams}, z).reconstruction)
    out = dec(torch.tensor(z)).reconstruction.detach().numpy()
    assert out.shape == ref.shape == (2, B, 3, 64, 64)
    np.testing.assert_allclose(out, ref, **NET_TOL)


# ------------------------------------------------------- MVTCAE on CUB
class _JMVTCAE(JMVTCAE):
    """The JAX MVTCAE with two stand-ins for what it cannot do with a
    token-dict modality: its parameter init feeds every encoder a float
    array of ``input_dims`` (``_dummy_input``), and its joint NLL indexes
    the target ``batch.data[m][None]``, which a dict refuses. The NLL's
    text target is given one-hot instead, which ``cross_entropy`` scores
    as it scores the tokens."""

    def _dummy_input(self, mod):
        if mod == "text":
            return {"tokens": jnp.zeros((1, L), jnp.int32), "padding_mask": jnp.ones((1, L))}
        return super()._dummy_input(mod)

    def _joint_nll(self, params, batch, rng, *, K, batch_size_K):
        joint_mu, joint_log_var, _ = self._joint_posterior(params, batch)
        tokens = batch.data["text"]["tokens"]
        target = batch.replace(data={**batch.data, "text": jax.nn.one_hot(
            tokens, self.input_dims["text"][-1])})
        return self._gaussian_iwae_joint_nll(params, target, joint_mu, joint_log_var, rng,
                                             K, batch_size_K)


@pytest.fixture(scope="module")
def cub_rows(tmp_path_factory):
    """8 rows of the CUB train split, from files, in both packages."""
    root = str(tmp_path_factory.mktemp("cub"))
    write_cub(root, n_train=2, n_test=1, seed=3)
    ours = CUB(root, "train", max_words_in_caption=L, output_type="tokens")
    ref = JCUB(root, "train", max_words_in_caption=L, output_type="tokens")
    assert ours.vocab_size == ref.vocab_size
    rows = np.arange(8)
    data, jdata = ours.get_batch(rows)["data"], ref.get_batch(rows)["data"]
    for k in ("tokens", "padding_mask"):
        np.testing.assert_array_equal(data["text"][k], jdata["text"][k])
    np.testing.assert_array_equal(data["image"], jdata["image"])
    assert data["text"]["padding_mask"].min() == 0   # some captions are padded
    return data, ours.vocab_size


def _kwargs(vocab):
    dims = {"image": (3, 64, 64), "text": (L, vocab)}
    return (dict(n_modalities=2, input_dims=dims, latent_dim=LATENT,
                 decoders_dist={"image": "laplace", "text": "categorical"}, beta=5.0,
                 alpha=0.9),
            dict(embed_size=E, nhead=HEADS, ff_size=FF, n_layers=LAYERS))


@functools.cache
def _jax_model(vocab):
    """The JAX model, built once for the tests that only read it (its
    init, compiled, is most of their time)."""
    kw, text = _kwargs(vocab)
    with compiled_init(JMVTCAE):
        jmodel = _JMVTCAE(JMVTCAEConfig(**kw), seed=0, encoders={
            "image": jcub.CUB_Resnet_Encoder(latent_dim=LATENT, nfilter=NF, nfilter_max=NF_MAX),
            "text": jcub.CubTextEncoder(latent_dim=LATENT, max_sentence_length=L,
                                        ntokens=vocab, **text)}, decoders={
            "image": jcub.CUB_Resnet_Decoder(latent_dim=LATENT, nfilter=NF, nfilter_max=NF_MAX),
            "text": jcub.CubTextDecoderMLP(JAEConfig(latent_dim=LATENT, input_dim=(L, vocab)))})
    return jmodel


def _models(vocab):
    """The shared JAX model and a fresh port model with its weights."""
    kw, text = _kwargs(vocab)
    jmodel = _jax_model(vocab)
    tmodel = MVTCAE(MVTCAEConfig(**kw), device="cpu", encoders={
        "image": cub.CUB_Resnet_Encoder(LATENT, nfilter=NF, nfilter_max=NF_MAX),
        "text": cub.CubTextEncoder(LATENT, L, vocab, **text)}, decoders={
        "image": cub.CUB_Resnet_Decoder(LATENT, nfilter=NF, nfilter_max=NF_MAX),
        "text": cub.CubTextDecoderMLP(BaseAEConfig(latent_dim=LATENT, input_dim=(L, vocab)))})
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jmodel.params)))
    return jmodel, tmodel


def test_mvtcae_on_cub_files_matches_jax(cub_rows):
    """Loss, ``loss_sum``, every metric and every gradient on the 8 rows."""
    data, vocab = cub_rows
    jmodel, tmodel = _models(vocab)
    key = jax.random.key(1)
    jbatch = j_batch_from_arrays(data=data)
    step = JStepInfo.create(epoch=1, dataset_size=8)

    def loss(params):
        out = jmodel.loss_function(params, jbatch, key, step)
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jmodel.params)
    tmodel.draw_noise = _JaxNoise(key)
    batch = batch_from_arrays(data=data)
    assert batch.n_samples == 8 and batch.data["text"]["tokens"].dtype == torch.int64
    out = tmodel.loss_function(batch)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(ref.loss), **LOSS_TOL)
    np.testing.assert_allclose(out.loss_sum.item(), float(ref.loss_sum), **LOSS_TOL)
    assert set(out.metrics) == set(ref.metrics)
    for k, v in out.metrics.items():
        np.testing.assert_allclose(v.item(), float(ref.metrics[k]), err_msg=k, **LOSS_TOL)
    expected = params_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(expected)
    for name, g in grads.items():
        ref = expected[name].numpy()
        atol = max(GRAD_ATOL, GRAD_FLOOR * float(np.abs(ref).max()))
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL, atol=atol, err_msg=name)


def test_mvtcae_on_cub_encode_predict_and_nll_match_jax(cub_rows):
    data, vocab = cub_rows
    jmodel, tmodel = _models(vocab)
    key = jax.random.key(2)
    inputs = {"data": data}
    for cond in ("text", "image", "all"):
        ref = jmodel.encode(inputs, cond_mod=cond, N=3, rng=key)
        tmodel.draw_noise = _JaxNoise(key)
        out = tmodel.encode(inputs, cond_mod=cond, N=3)
        assert out.z.shape == ref.z.shape == (3, 8, LATENT)
        np.testing.assert_allclose(out.z.detach().numpy(), np.asarray(ref.z), err_msg=cond,
                                   **VALUE_TOL)
        ref = jmodel.predict(inputs, cond_mod=cond, gen_mod="all", N=2, rng=key)
        tmodel.draw_noise = _JaxNoise(key)
        out = tmodel.predict(inputs, cond_mod=cond, gen_mod="all", N=2)
        assert out["text"].shape == (2, 8, L, vocab)
        for m in ("image", "text"):
            np.testing.assert_allclose(out[m].detach().numpy(), np.asarray(ref[m]),
                                       err_msg=f"{cond} -> {m}", **VALUE_TOL)

    with pytest.raises(KeyError):   # the JAX estimator's own target
        JMVTCAE._joint_nll(jmodel, jmodel.params, j_batch_from_arrays(data=data), key,
                           K=2, batch_size_K=2)
    ref = float(jmodel.compute_joint_nll(inputs, K=5, batch_size_K=2, rng=key))
    tmodel.draw_noise = _JaxNoise(key, chain=True)
    out = tmodel.compute_joint_nll(inputs, K=5, batch_size_K=2)
    assert tmodel.draw_noise.shapes == [(2, 8, LATENT), (2, 8, LATENT), (1, 8, LATENT)]
    np.testing.assert_allclose(out.item(), ref, **LOSS_TOL)
