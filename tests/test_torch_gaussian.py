"""The port's PoE, Gaussian sampling, chunked IWAE and cross-entropy ops
against the JAX package's, on the CPU with numpy-seeded inputs.

Values and gradients of ``poe`` / ``masked_poe`` / ``stable_poe`` are
compared on masks with a missing expert, a row with every expert missing
and a row whose live experts' total precision is below 1e-20; noise is
drawn with ``jax.random`` and fed to the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multivae_tpu.ops.dists as jd
import multivae_tpu.ops.gaussian as jg
import multivae_tpu.ops.iwae as jiwae
from multivae_tpu_torch.ops import dists as td
from multivae_tpu_torch.ops import gaussian as tg
from multivae_tpu_torch.ops import iwae as tiwae

torch.set_num_threads(2)

M, B, D = 3, 6, 5
# Elementwise float32 formulas and sums of <= 5 terms: a few ulps of values
# of order 1-10. Gradients go through 1/total_precision: 1e-5 relative.
TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _experts(seed=0):
    r = np.random.default_rng(seed)
    mus = r.normal(size=(M, B, D)).astype(np.float32)
    log_vars = r.normal(size=(M, B, D)).astype(np.float32)
    mask = np.ones((M, B), np.float32)
    mask[1, 0] = 0.0          # a missing expert
    mask[:, 1] = 0.0          # a row with no expert: dead
    mask[2, 2] = 0.0
    log_vars[:, 3] = 50.0     # live row, total precision ~ 6e-22 <= 1e-20: dead
    return mus, log_vars, mask


def _both(jfn, tfn, mus, log_vars, mask, cot_seed=1):
    """Values and (mu, log_var) gradients of sum(c1 * out_mu + c2 * out_lv)."""
    r = np.random.default_rng(cot_seed)
    c = [r.normal(size=(B, D)).astype(np.float32) for _ in range(2)]

    def jloss(mu, lv):
        a, b = jfn(mu, lv, None if mask is None else jnp.asarray(mask))
        return jnp.sum(a * c[0] + b * c[1]), (a, b)

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(mus), jnp.asarray(log_vars))
    tm = torch.tensor(mus, requires_grad=True)
    tl = torch.tensor(log_vars, requires_grad=True)
    a, b = tfn(tm, tl, None if mask is None else torch.tensor(mask))
    (a * torch.tensor(c[0]) + b * torch.tensor(c[1])).sum().backward()
    return ((np.asarray(jout[0]), np.asarray(jout[1]), *map(np.asarray, jgrads)),
            (a.detach().numpy(), b.detach().numpy(), tm.grad.numpy(), tl.grad.numpy()))


def _check(ref, out):
    for name, r, o, tol in zip(("mu", "log_var", "dmu", "dlog_var"), ref, out,
                               (TOL, TOL, GRAD_TOL, GRAD_TOL)):
        assert np.isfinite(o).all(), name
        np.testing.assert_allclose(o, r, err_msg=name, **tol)


def test_poe_matches_jax():
    mus, log_vars, _ = _experts()
    log_vars[:, 3] = 0.0
    ref, out = _both(lambda m, v, _: jg.poe(m, v), lambda m, v, _: tg.poe(m, v),
                     mus, log_vars, None)
    _check(ref, out)


@pytest.mark.parametrize("prior_expert", [False, True])
def test_masked_poe_matches_jax(prior_expert):
    mus, log_vars, mask = _experts()
    ref, out = _both(lambda m, v, k: jg.masked_poe(m, v, k, prior_expert=prior_expert),
                     lambda m, v, k: tg.masked_poe(m, v, k, prior_expert=prior_expert),
                     mus, log_vars, mask)
    _check(ref, out)


def test_masked_poe_masked_experts_get_exactly_zero_gradient():
    mus, log_vars, mask = _experts()
    _, (_, _, dmu, dlv) = _both(jg.masked_poe, tg.masked_poe, mus, log_vars, mask)
    dead = mask == 0
    assert (dmu[dead] == 0).all() and (dlv[dead] == 0).all()
    healthy = ~dead
    healthy[:, 3] = False     # the low-precision row's gradients are ~1e-22
    assert (np.abs(dmu[healthy]).sum(-1) > 0).all()


def test_masked_poe_dead_rows_fall_back_to_the_prior():
    mus, log_vars, mask = _experts()
    mu, lv = tg.masked_poe(torch.tensor(mus), torch.tensor(log_vars), torch.tensor(mask))
    # row 1: no expert; row 3: total precision 3 * exp(-50) below 1e-20
    np.testing.assert_array_equal(mu[1].numpy(), 0.0)
    np.testing.assert_array_equal(lv[1].numpy(), 0.0)
    np.testing.assert_allclose(mu[3].numpy(), 0.0, atol=1e-20)
    np.testing.assert_allclose(lv[3].numpy(), 0.0, atol=1e-20)
    # live rows are untouched: the plain PoE of their unmasked experts
    keep = mask[:, 4] > 0
    ref_mu, ref_lv = tg.poe(torch.tensor(mus[keep, 4]), torch.tensor(log_vars[keep, 4]))
    np.testing.assert_allclose(mu[4].numpy(), ref_mu.numpy(), **TOL)
    np.testing.assert_allclose(lv[4].numpy(), ref_lv.numpy(), **TOL)


def test_masked_poe_broadcasts_the_mask_over_feature_maps():
    r = np.random.default_rng(3)
    mus, log_vars = (r.normal(size=(M, B, 2, 3, 3)).astype(np.float32) for _ in range(2))
    mask = (r.uniform(size=(M, B)) > 0.3).astype(np.float32)
    ref = jg.masked_poe(jnp.asarray(mus), jnp.asarray(log_vars), jnp.asarray(mask))
    out = tg.masked_poe(torch.tensor(mus), torch.tensor(log_vars), torch.tensor(mask))
    for r_, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r_), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_stable_poe_matches_jax(masked):
    mus, log_vars, mask = _experts()
    log_vars[:, 3] = 0.0
    ref, out = _both(jg.stable_poe, tg.stable_poe, mus, log_vars,
                     mask if masked else None)
    _check(ref, out)
    if masked:
        dmu, dlv = out[2], out[3]
        assert (dmu[mask == 0] == 0).all() and (dlv[mask == 0] == 0).all()
        assert (out[0][1] == 0).all() and (out[1][1] == 0).all()


def test_stable_poe_single_expert_is_identity():
    mu, lv = torch.randn(1, B, D), torch.randn(1, B, D)
    a, b = tg.stable_poe(mu, lv)
    assert torch.equal(a, mu[0]) and torch.equal(b, lv[0])


def test_kl_and_gaussian_log_prob_match_jax():
    r = np.random.default_rng(4)
    a = [r.normal(size=(B, D)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(tg.kl_divergence(*map(torch.tensor, a)).numpy(),
                               np.asarray(jg.kl_divergence(*a)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.gaussian_log_prob(*map(torch.tensor, a[:3])).numpy(),
                               np.asarray(jg.gaussian_log_prob(*a[:3])), **TOL)


@pytest.mark.parametrize("mu_shape,N,flatten,expected", [
    ((B, D), 1, False, (B, D)),
    ((B, D), 4, False, (4, B, D)),
    ((B, D), 4, True, (4 * B, D)),
    ((D,), 4, True, (4, D)),      # a 1-D mu is a batch of one
    ((D,), 1, True, (D,)),
])
@pytest.mark.parametrize("return_mean", [False, True])
def test_rsample_shapes_and_values_match_jax(mu_shape, N, flatten, expected,
                                             return_mean):
    r = np.random.default_rng(5)
    mu, lv = (r.normal(size=mu_shape).astype(np.float32) for _ in range(2))
    key = jax.random.key(6)
    ref = np.asarray(jg.rsample_from_gaussian(key, jnp.asarray(mu), jnp.asarray(lv),
                                              N=N, return_mean=return_mean,
                                              flatten=flatten))
    shape = mu_shape if N == 1 else (N, *mu_shape)
    noise = torch.tensor(np.asarray(jax.random.normal(key, shape)))
    out = tg.rsample_from_gaussian(torch.tensor(mu), torch.tensor(lv), N=N,
                                   return_mean=return_mean, flatten=flatten,
                                   noise=noise)
    assert out.shape == expected == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_rsample_draws_from_the_generator():
    mu, lv = torch.zeros(B, D), torch.zeros(B, D)
    a = tg.rsample_from_gaussian(mu, lv, N=3, generator=torch.Generator().manual_seed(0))
    b = tg.rsample_from_gaussian(mu, lv, N=3, generator=torch.Generator().manual_seed(0))
    assert a.shape == (3, B, D) and torch.equal(a, b)


class _JaxKeyChain:
    """The noise of each chunk as ``ops/iwae.py`` draws it: the carry key
    is split once per chunk, full chunks and the remainder alike."""

    def __init__(self, key):
        self.key = key

    def normal(self, shape):
        self.key, sub = jax.random.split(self.key)
        return np.asarray(jax.random.normal(sub, shape))


@pytest.mark.parametrize("K,chunk", [(7, 3), (6, 3), (5, 10)])
def test_iwae_log_marginal_matches_jax(K, chunk):
    scale = np.random.default_rng(7).uniform(1, 3, size=(B,)).astype(np.float32)

    def jlogw(rng, n):
        return 4.0 * jax.random.normal(rng, (n, B)) * scale

    key = jax.random.key(8)
    ref = np.asarray(jiwae.iwae_log_marginal(jlogw, key, K, chunk))
    chain = _JaxKeyChain(key)
    sizes = []

    def logw(n):
        sizes.append(n)
        return 4.0 * torch.tensor(chain.normal((n, B))) * torch.tensor(scale)

    out = tiwae.iwae_log_marginal(logw, K, chunk)
    assert sum(sizes) == K and sizes[-1] == (K % min(chunk, K) or min(chunk, K))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_chunked_logsumexp_matches_jax():
    K, chunk = 7, 3

    def jlse(rng, n):
        return jax.nn.logsumexp(3.0 * jax.random.normal(rng, (n, B)), axis=0)

    key = jax.random.key(9)
    ref = np.asarray(jiwae.chunked_logsumexp(jlse, key, K, chunk))
    chain = _JaxKeyChain(key)
    out = tiwae.chunked_logsumexp(
        lambda n: torch.logsumexp(3.0 * torch.tensor(chain.normal((n, B))), 0), K, chunk)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("target_kind", ["array", "one_hot", "tokens", "logits_dict"])
def test_cross_entropy_matches_jax(target_kind):
    r = np.random.default_rng(10)
    logits = r.normal(size=(4, 7, 11)).astype(np.float32)
    tokens = r.integers(0, 11, size=(4, 7))
    tokens[0, 0] = -1                      # padding: a zero row in both
    one_hot = np.asarray(jax.nn.one_hot(tokens, 11), np.float32)
    jl, tl = jnp.asarray(logits), torch.tensor(logits)
    if target_kind == "array":
        args = (jl, jnp.asarray(one_hot)), (tl, torch.tensor(one_hot))
    elif target_kind == "one_hot":
        args = ((jl, {"one_hot": jnp.asarray(one_hot)}),
                (tl, {"one_hot": torch.tensor(one_hot)}))
    elif target_kind == "tokens":
        args = ((jl, {"tokens": jnp.asarray(tokens)}),
                (tl, {"tokens": torch.tensor(tokens)}))
    else:
        args = (({"one_hot": jl}, {"tokens": jnp.asarray(tokens)}),
                ({"one_hot": tl}, {"tokens": torch.tensor(tokens)}))
    ref = np.asarray(jd.set_decoder_dist("categorical", {})(*args[0]))
    out = td.set_decoder_dist("categorical", {})(*args[1]).numpy()
    assert out.shape == logits.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert (out[0, 0] == 0).all()
    with pytest.raises(NotImplementedError):
        td.cross_entropy({"tokens": tl}, one_hot)
