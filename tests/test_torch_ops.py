"""The port's K-sample ops, DReG gradient scaling and reconstruction
log-probs against the JAX package's, on the CPU with numpy-seeded inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multivae_tpu.ops.dists as jd
import multivae_tpu.ops.dreg as jdreg
import multivae_tpu.ops.kdist as jk
from multivae_tpu_torch.ops import dists as td
from multivae_tpu_torch.ops import kdist as tk
from multivae_tpu_torch.ops.dreg import scale_grad
from torch_parity import LAPLACE_LOW, normal, uniform

torch.set_num_threads(2)

# Elementwise float32 formulas, same operations on both sides: agreement to
# a few ulps of the values (|x| <~ 10).
TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dist", ["laplace_with_softmax", "normal",
                                  "normal_with_softplus"])
def test_log_var_to_std(dist):
    lv = _rng().normal(size=(4, 7)).astype(np.float32)
    ref = np.asarray(jk.log_var_to_std(jnp.asarray(lv), dist))
    out = tk.log_var_to_std(torch.tensor(lv), dist).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("dist", ["laplace_with_softmax", "normal"])
def test_dist_log_prob(dist):
    r = _rng(1)
    x, loc = (r.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(2))
    scale = r.uniform(0.3, 2.0, size=(4, 5)).astype(np.float32)
    ref = np.asarray(jk.dist_log_prob(dist, x, loc, scale))
    out = tk.dist_log_prob(dist, *(torch.tensor(a) for a in (x, loc, scale)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("dist", ["laplace_with_softmax", "normal"])
@pytest.mark.parametrize("K", [1, 3])
def test_dist_rsample_with_the_jax_noise(dist, K):
    """Fed the noise ``jax.random`` draws inside ``dist_rsample``, the
    port's transform gives JAX's samples."""
    r = _rng(2)
    loc = r.normal(size=(6, 5)).astype(np.float32)
    scale = r.uniform(0.3, 2.0, size=(6, 5)).astype(np.float32)
    key = jax.random.key(3)
    shape = loc.shape if K == 1 else (K, *loc.shape)
    if dist == "laplace_with_softmax":
        eps = float(jnp.finfo(jnp.float32).eps)
        u = jax.random.uniform(key, shape, jnp.float32, -0.5 + eps, 0.5)
    else:
        u = jax.random.normal(key, shape, jnp.float32)
    ref = np.asarray(jk.dist_rsample(key, dist, loc, scale, K=K))
    out = tk.dist_rsample(dist, torch.tensor(loc), torch.tensor(scale), K=K,
                          u=torch.tensor(np.asarray(u)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("shape", [(), (1,), (3, 5), (2, 1, 3, 7), (1025,)])
@pytest.mark.parametrize("draw", ["normal", "laplace"])
def test_parity_draws_are_jax_random(draw, shape):
    """The tests' JAX noise (``torch_parity``), drawn as the head of a longer
    draw, is bit for bit ``jax.random``'s draw of the shape itself."""
    key = jax.random.split(jax.random.key(4))[1]
    if draw == "normal":
        ours, ref = normal(key, shape), jax.random.normal(key, shape)
    else:
        ours = uniform(key, shape, LAPLACE_LOW, 0.5)
        ref = jax.random.uniform(key, shape, jnp.float32, LAPLACE_LOW, 0.5)
    assert ours.shape == shape and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_dist_rsample_k_keeps_the_k_axis():
    loc, scale = torch.zeros(6, 5), torch.ones(6, 5)
    gen = torch.Generator().manual_seed(0)
    z1 = tk.dist_rsample_k("laplace_with_softmax", loc, scale, 1, generator=gen)
    z4 = tk.dist_rsample_k("normal", loc, scale, 4, generator=gen)
    assert z1.shape == (1, 6, 5) and z4.shape == (4, 6, 5)
    ref = jk.dist_rsample_k(jax.random.key(0), "normal", jnp.zeros((6, 5)),
                            jnp.ones((6, 5)), 1)
    assert ref.shape == z1.shape


def test_sample_noise_range_and_generator():
    u = tk.sample_noise("laplace_with_softmax", (20000,),
                        generator=torch.Generator().manual_seed(0))
    eps = torch.finfo(torch.float32).eps
    assert u.min() >= -0.5 + eps and u.max() < 0.5
    again = tk.sample_noise("laplace_with_softmax", (20000,),
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(u, again)
    n = tk.sample_noise("normal", (20000,), generator=torch.Generator().manual_seed(1))
    assert abs(n.mean().item()) < 0.05 and abs(n.std().item() - 1) < 0.05


def test_scale_grad_matches_jax():
    r = _rng(4)
    x = r.normal(size=(3, 4, 2)).astype(np.float32)
    w = r.uniform(size=(3, 4, 1)).astype(np.float32)
    c = r.normal(size=(3, 4, 2)).astype(np.float32)

    def jloss(x):
        return (jdreg.scale_grad(x, jnp.asarray(w)) * c).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = scale_grad(xt, wt)
    assert torch.equal(y, xt.detach())
    (y * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, **TOL)
    assert wt.grad is None


def test_scale_grad_keeps_the_cotangent_dtype():
    x = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    y = scale_grad(x, torch.full((4,), 0.5))
    y.backward(torch.ones(4, dtype=torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, torch.full((4,), 0.5, dtype=torch.bfloat16))


@pytest.mark.parametrize("name,params", [
    ("normal", {}), ("normal", {"scale": 0.75}), ("laplace", {}),
    ("laplace", {"scale": 0.75}), ("bernoulli", {})])
def test_recon_log_probs(name, params):
    r = _rng(5)
    recon = r.normal(size=(4, 3, 5)).astype(np.float32)
    target = r.uniform(size=(4, 3, 5)).astype(np.float32)
    ref = np.asarray(jd.set_decoder_dist(name, params)(recon, target))
    out = td.set_decoder_dist(name, params)(torch.tensor(recon),
                                             torch.tensor(target))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_unknown_decoder_dist_raises():
    with pytest.raises(ValueError, match="not supported"):
        td.set_decoder_dist("poisson", {})
    # 'categorical' is a known name: it maps to cross_entropy
    assert td.set_decoder_dist("categorical", {}) is td.cross_entropy
