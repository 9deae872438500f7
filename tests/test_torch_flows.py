"""The port's MADE / MAF / IAF (``multivae_tpu_torch/ops/flows.py``) against
the JAX package's Flax modules, on the CPU: D=5 and D=1 (where the output
mask is all zeros), 2 hidden layers of 8, 2 blocks.

Weights cross with ``flow_from_jax``. Compared: the masks exactly; a MADE
block's (mu, alpha); each direction's output and log-determinant, ``log_prob`` and its gradients
with respect to every weight and to the input (``jax.grad``); the round
trip. One jitted JAX run per (flow, D) is shared by the tests of a case.

Tolerances: the parallel direction is a few float32 matmuls (rtol 1e-5,
atol 1e-6). The sequential direction repeats a MADE pass D times per block,
each fed the last one's output (rtol 1e-5, atol 1e-5). The gradients go
through the same passes (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.ops import flows as jflows
from multivae_tpu_torch.ops import flows
from multivae_tpu_torch.utils.convert import flow_from_jax

torch.set_num_threads(2)

HIDDEN, N_HIDDEN, BLOCKS, ROWS = 8, 2, 2, 6
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
SEQ_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [(cls, d) for cls in ("MAF", "IAF") for d in (5, 1)]


@pytest.mark.parametrize("input_dim", [5, 1, 3])
def test_made_masks_match_jax(input_dim):
    hidden = (HIDDEN, 4, HIDDEN)
    masks, out = flows.made_masks(input_dim, hidden)
    jmasks, jout = jflows.made_masks(input_dim, hidden)
    assert len(masks) == len(jmasks) == 3
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(out, jout)
    assert out.any() == (input_dim > 1)
    # the port's layers hold the transposes as their (out, in) buffers
    made = flows.MADE(input_dim, hidden)
    np.testing.assert_array_equal(made.hidden[0].mask.numpy(), jmasks[0].T)
    np.testing.assert_array_equal(made.mu.mask.numpy(), jout.T)
    assert "hidden.0.mask" not in made.state_dict()


def _x(d, seed=0):
    return np.random.default_rng(seed).normal(size=(ROWS, d)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """(JAX params, every JAX value) per (flow, D), computed once."""
    runs = {}
    for cls, d in CASES:
        flow = getattr(jflows, cls)(input_dim=d, n_made_blocks=BLOCKS, hidden_size=HIDDEN,
                                    n_hidden_in_made=N_HIDDEN)
        variables = jax.jit(flow.init)(jax.random.key(d), jnp.zeros((1, d)))
        # nonzero biases, so that a misplaced bias shows
        rng = np.random.default_rng(7)
        variables = jax.tree.map(
            lambda v: np.asarray(v) + rng.normal(scale=0.1, size=v.shape).astype(np.float32),
            variables)

        @jax.jit
        def run(variables, x, flow=flow):
            fwd = flow.apply(variables, x)
            inv = flow.apply(variables, x, method=type(flow).inverse)
            made = flow.apply(variables, x, method=lambda f, x: f.blocks[0](x))

            def lp(v, x):
                return flow.apply(v, x, method=type(flow).log_prob).sum()

            return fwd, inv, flow.apply(variables, x, method=type(flow).log_prob), \
                jax.grad(lp, argnums=(0, 1))(variables, x), made

        x = _x(d)
        runs[cls, d] = variables, jax.tree.map(np.asarray, run(variables, x))
    return runs


def _port(cls, d, variables):
    flow = getattr(flows, cls)(d, n_made_blocks=BLOCKS, hidden_size=HIDDEN,
                               n_hidden_in_made=N_HIDDEN)
    flow.load_state_dict(flow_from_jax(jax.tree.map(np.asarray, variables)))
    return flow


@pytest.mark.parametrize("d", [5, 1])
def test_made_matches_flax(reference, d):
    """A MAF's first MADE block alone: (mu, alpha), the output layers
    masked (at D=1 fully: mu is the bias), alpha bounded by 3 tanh."""
    variables, (*_, (mu, alpha)) = reference["MAF", d]
    made = _port("MAF", d, variables).blocks[0]
    with torch.no_grad():
        tmu, talpha = made(torch.tensor(_x(d)))
    np.testing.assert_allclose(tmu.numpy(), mu, **OUT_TOL)
    np.testing.assert_allclose(talpha.numpy(), alpha, **OUT_TOL)
    assert talpha.abs().max() <= 3.0
    if d == 1:
        bias = np.asarray(variables["params"]["blocks_0"]["mu"]["bias"])
        np.testing.assert_allclose(tmu.numpy(), np.broadcast_to(bias, (ROWS, 1)), rtol=1e-6)


@pytest.mark.parametrize("cls,d", CASES)
def test_directions_log_prob_and_gradients_match_jax(reference, cls, d):
    variables, (fwd, inv, log_prob, (jgrads, jdx), _) = reference[cls, d]
    flow = _port(cls, d, variables)
    x = torch.tensor(_x(d))
    with torch.no_grad():
        out, back = flow(x), flow.inverse(x)
    # the parallel direction: MAF's forward, IAF's inverse
    parallel, sequential = (out, back) if cls == "MAF" else (back, out)
    jpar, jseq = (fwd, inv) if cls == "MAF" else (inv, fwd)
    for ours, ref, tol in ((parallel, jpar, OUT_TOL), (sequential, jseq, SEQ_TOL)):
        assert ours["out"].shape == (ROWS, d) and ours["log_abs_det_jac"].shape == (ROWS,)
        for key in ("out", "log_abs_det_jac"):
            np.testing.assert_allclose(ours[key].numpy(), ref[key], err_msg=key, **tol)

    # log_prob, and its gradients with respect to every weight and to x
    x.requires_grad_()
    lp = flow.log_prob(x)
    np.testing.assert_allclose(lp.detach().numpy(), log_prob, **SEQ_TOL)
    lp.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jdx, **GRAD_TOL)
    ref = flow_from_jax(jgrads)
    grads = {n: p.grad for n, p in flow.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        if d == 1 and ".weight" in name and not name.split(".")[2].startswith("hidden"):
            # the output layers are fully masked: their weights get a zero
            # gradient
            assert not g.any() and not ref[name].any(), name
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("cls", ["MAF", "IAF"])
def test_round_trip_and_reset(cls):
    flow = getattr(flows, cls)(5, hidden_size=HIDDEN)
    flow.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.05)          # nonzero biases
        x = torch.tensor(_x(5, seed=3))
        u = flow(x)
        back = flow.inverse(u["out"])
    np.testing.assert_allclose(back["out"].numpy(), x.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back["log_abs_det_jac"].numpy(),
                               -u["log_abs_det_jac"].numpy(), rtol=1e-4, atol=1e-5)
    # Glorot-uniform weights, zero biases, from the generator
    again = getattr(flows, cls)(5, hidden_size=HIDDEN)
    again.reset_parameters(torch.Generator().manual_seed(0))
    lin = again.blocks[0].hidden[1]
    assert not lin.bias.any()
    assert lin.weight.abs().max() <= (6 / (2 * HIDDEN)) ** 0.5
    third = getattr(flows, cls)(5, hidden_size=HIDDEN)
    third.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), third.parameters()))
