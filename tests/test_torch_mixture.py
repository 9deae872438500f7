"""The port's mixture log-density (``multivae_tpu_torch/ops/mixture.py``)
against the JAX package's on the CPU.

On CPU tensors the port runs its plain version, a PyTorch copy of
``mixture_log_density_xla``; these tests hold it against that XLA
composition and against the TPU kernel itself (``_mixture_pallas`` in
Pallas interpret mode), values and gradients, for both distributions. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multivae_tpu.ops.pallas_mixture as pm
from multivae_tpu_torch.ops import mixture as mx
from multivae_tpu_torch.ops.kdist import mixture_logsumexp

torch.set_num_threads(2)

MQ, MZ, K, B, D = 3, 3, 4, 16, 32
# float32 on both sides, same formula, sums over D=32 terms in another
# order: a few ulps of |out| ~ 10^2 for the values; gradients go through
# exp(lq - out), so they carry that absolute error as a relative one.
OUT_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def interpret_mode():
    pm._INTERPRET = True
    yield
    pm._INTERPRET = False


def _inputs(seed=0, fully_masked_column=False):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(MZ, K, B, D)).astype(np.float32)
    mus = rng.normal(size=(MQ, B, D)).astype(np.float32)
    sig = rng.uniform(0.5, 1.5, size=(MQ, B, D)).astype(np.float32)
    mask = np.ones((MQ, B), np.float32)
    mask[1, :5] = 0.0
    if fully_masked_column:
        mask[:, 0] = 0.0
    g = rng.normal(size=(MZ, K, B)).astype(np.float32)
    return z, mus, sig, mask, g


def _torch_value_and_grads(fn, z, mus, sig, mask, g, dist):
    leaves = [torch.tensor(a, requires_grad=True) for a in (z, mus, sig)]
    out = fn(*leaves, torch.tensor(mask), dist)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_value_and_grads(fn, z, mus, sig, mask, g, dist):
    def loss(z, m, s):
        out = fn(z, m, s, jnp.asarray(mask), dist)
        return (out * g).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(z), jnp.asarray(mus), jnp.asarray(sig))
    return np.asarray(out), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_matches_jax_xla(dist):
    args = _inputs()
    ref = np.asarray(pm.mixture_log_density_xla(
        *(jnp.asarray(a) for a in args[:4]), dist))
    out = mx.mixture_log_density_plain(*(torch.tensor(a) for a in args[:4]), dist)
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_gradients_match_jax_xla(dist):
    args = _inputs(seed=1)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_j, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla,
                                          *args, dist)
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, **GRAD_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_plain_matches_tpu_kernel_in_interpret_mode(interpret_mode, dist):
    """Values and the hand-written VJP of the Pallas kernel (forward and
    backward kernels, run in interpret mode) vs the port's plain version."""
    args = _inputs(seed=2)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_p, grads_p = _jax_value_and_grads(pm._mixture_pallas, *args, dist)
    np.testing.assert_allclose(out_t, out_p, **OUT_TOL)
    for gt, gp in zip(grads_t, grads_p):
        np.testing.assert_allclose(gt, gp, **GRAD_TOL)


@pytest.mark.parametrize("dist", ["laplace", "normal"])
def test_fully_masked_column(dist):
    """A column with every expert masked gives the XLA value (-1e30) and
    exactly zero gradient, and leaves the other columns' gradients finite
    and equal to JAX's."""
    args = _inputs(seed=3, fully_masked_column=True)
    out_t, grads_t = _torch_value_and_grads(mx.mixture_log_density_plain,
                                            *args, dist)
    out_j, grads_j = _jax_value_and_grads(pm.mixture_log_density_xla,
                                          *args, dist)
    np.testing.assert_allclose(out_t, out_j, **OUT_TOL)
    for gt, gj in zip(grads_t, grads_j):
        assert np.isfinite(gt).all()
        np.testing.assert_allclose(gt, gj, **GRAD_TOL)
    assert (grads_t[0][:, :, 0] == 0).all()
    assert (grads_t[1][:, 0] == 0).all() and (grads_t[2][:, 0] == 0).all()


def test_masked_expert_gets_zero_gradient():
    z, mus, sig, mask, g = _inputs(seed=4)
    _, grads = _torch_value_and_grads(mx.mixture_log_density_plain,
                                      z, mus, sig, mask, g, "laplace")
    assert (grads[1][1, :5] == 0).all() and (grads[2][1, :5] == 0).all()
    assert (grads[1][1, 5:] != 0).any()


def test_cpu_dispatch_runs_plain_version_without_launching():
    args = [torch.tensor(a) for a in _inputs(seed=5)[:4]]
    before = dict(mx.launches)
    out = mixture_logsumexp(*args, "laplace_with_softmax")
    assert mx.launches == before
    torch.testing.assert_close(out, mx.mixture_log_density_plain(*args, "laplace"),
                               rtol=0, atol=0)


def test_kernel_input_checks():
    """What the CUDA path refuses, checked before any launch: another
    dist, a non-float32 or non-contiguous input, an input off the card."""
    z, mus, sig, mask = (torch.tensor(a) for a in _inputs()[:4])
    with pytest.raises(ValueError, match="dist"):
        mx._check_inputs(z, mus, sig, mask, "cauchy")
    with pytest.raises(TypeError, match="float32"):
        mx._check_inputs(z.double(), mus, sig, mask, "laplace")
    with pytest.raises(ValueError, match="contiguous"):
        mx._check_inputs(z.transpose(2, 3), mus, sig, mask, "laplace")
    with pytest.raises(ValueError, match="CUDA device"):
        mx._check_inputs(z, mus, sig, mask, "laplace")


def test_mixed_devices_never_reach_the_plain_version():
    """Only all-CPU inputs take the plain version; anything else goes to
    the kernel's checks (here: a meta-device z is refused)."""
    z, mus, sig, mask = (torch.tensor(a) for a in _inputs()[:4])
    with pytest.raises(ValueError, match="CUDA device"):
        mx.mixture_log_density(z.to("meta"), mus, sig, mask, "laplace")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc, building a kernel fails loudly."""
    from multivae_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["mixture"])
