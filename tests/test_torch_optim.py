"""The port's optimizer factory against the JAX package's, on the CPU.

Both ``make_optimizer``s build the same name and parameters; 8 steps at lr
1e-2 on 64 parameters, fed the same gradients, must leave the same
parameters. Tolerance: the largest difference is within 1e-4 of the largest
parameter change (float32 noise of two implementations is ~1e-6 of it; the
divergences this pins, such as torch's AMSGrad or its RMSprop defaults,
read 3e-2 to 2 of it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from multivae_tpu.trainers.base.optim import make_optimizer as j_make_optimizer
from multivae_tpu_torch.trainers.base import optim as optim_module
from multivae_tpu_torch.trainers.base.optim import OptaxRule, make_optimizer

STEPS, N, LR = 8, 64, 1e-2
REL_TOL = 1e-4

CASES = [
    ("Adam", {}), ("Adam", {"amsgrad": True}), ("AdamW", {"weight_decay": 0.05}),
    ("AdamW", {}), ("Adagrad", {}), ("Adadelta", {}), ("SGD", {}),
    ("SGD", {"momentum": 0.9}), ("RMSprop", {}), ("Adamax", {}), ("RAdam", {}),
    # the other options of the JAX whitelist
    ("Adam", {"eps_root": 1e-6, "nesterov": True}), ("Adam", {"betas": (0.8, 0.99)}),
    ("AdamW", {"b1": 0.85, "nesterov": True}),
    ("Adagrad", {"eps": 1e-3, "initial_accumulator_value": 0.0}),
    ("RMSprop", {"centered": True, "momentum": 0.9}), ("RMSprop", {"decay": 0.99}),
    ("RMSprop", {"initial_scale": 1.0}), ("RAdam", {"threshold": 6.0}),
]


def _run_jax(name, kwargs, params, grads):
    tx = j_make_optimizer(name, LR, kwargs)
    p = jnp.asarray(params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    return np.asarray(p)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    params = rng.normal(size=N).astype(np.float32)
    # gradients of changing sign and scale, some entries near zero
    grads = [(rng.normal(size=N) * rng.uniform(0.01, 2.0, size=N)).astype(np.float32)
             for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("name,kwargs", CASES)
def test_updates_match_the_jax_package(name, kwargs):
    params, grads = _inputs(len(name) + len(kwargs))
    ref = _run_jax(name, kwargs, params, grads)
    p = torch.tensor(params, requires_grad=True)
    opt = make_optimizer(name, [p], LR, kwargs)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    moved = np.abs(ref - params).max()
    assert moved > 1e-4   # Adadelta moves least: 2.6e-4
    np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0, atol=REL_TOL * moved)


def test_torch_classes_where_they_compute_the_same_update():
    p = [torch.zeros(1, requires_grad=True)]
    assert type(make_optimizer("Adam", p, LR)) is torch.optim.Adam
    assert type(make_optimizer("AdamW", p, LR)) is torch.optim.AdamW
    assert make_optimizer("AdamW", p, LR).defaults["weight_decay"] == 1e-4
    for name in ("Adagrad", "RMSprop"):
        assert isinstance(make_optimizer(name, p, LR), OptaxRule)
    assert isinstance(make_optimizer("Adam", p, LR, {"amsgrad": True}), OptaxRule)


@pytest.mark.parametrize("name,kwargs,torch_form", [
    ("Adam", {"amsgrad": True}, lambda p: torch.optim.Adam(p, LR, amsgrad=True)),
    ("AdamW", {}, lambda p: torch.optim.AdamW(p, LR)),
    ("Adagrad", {}, lambda p: torch.optim.Adagrad(p, LR)),
    ("RMSprop", {}, lambda p: torch.optim.RMSprop(p, LR)),
])
def test_torch_own_formulas_and_defaults_diverge(name, kwargs, torch_form):
    """The four faults the factory repairs: torch's class with torch's
    defaults leaves other parameters than the JAX package."""
    params, grads = _inputs(7)
    ref = _run_jax(name, kwargs, params, grads)
    p = torch.tensor(params, requires_grad=True)
    opt = torch_form([p])
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
    moved = np.abs(ref - params).max()
    assert np.abs(p.detach().numpy() - ref).max() > 1e-2 * moved


@pytest.mark.parametrize("name,torch_spelling,optax_spelling", [
    ("Adam", {"betas": (0.8, 0.99), "amsgrad": True}, {"b1": 0.8, "b2": 0.99,
                                                        "amsgrad": True}),
    ("AdamW", {"amsgrad": False}, {}),
    ("RMSprop", {"alpha": 0.95}, {"decay": 0.95}),
])
def test_torch_spellings_are_the_optax_names(name, torch_spelling, optax_spelling):
    params, grads = _inputs(3)
    out = []
    for kwargs in (torch_spelling, optax_spelling):
        p = torch.tensor(params, requires_grad=True)
        opt = make_optimizer(name, [p], LR, kwargs)
        for g in grads:
            p.grad = torch.tensor(g)
            opt.step()
        out.append(p.detach())
    assert torch.equal(*out)


_ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=0.0,
             nesterov=False, amsgrad=False, decoupled=False, threshold=None)


def test_optax_rule_adam_is_torch_adam():
    """``OptaxRule``'s foreach Adam computes torch's Adam over several
    tensors (``tools/optim_timing.py`` times the two against each other).
    Tolerance as above."""
    params, grads = _inputs(5)
    out = []
    for make in (lambda ps: torch.optim.Adam(ps, LR),
                 lambda ps: OptaxRule(ps, optim_module._adam_rule, LR, **_ADAM)):
        ps = [torch.tensor(params[:40], requires_grad=True),
              torch.tensor(params[40:].reshape(4, 6), requires_grad=True)]
        opt = make(ps)
        for g in grads:
            ps[0].grad, ps[1].grad = torch.tensor(g[:40]), torch.tensor(g[40:].reshape(4, 6))
            opt.step()
        out.append(torch.cat([p.detach().reshape(-1) for p in ps]).numpy())
    moved = np.abs(out[0] - params).max()
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=REL_TOL * moved)


def test_optax_rule_keeps_each_parameter_s_step():
    """A parameter without a gradient skips the step; the others go on, and
    each is bias-corrected with its own step count, as one parameter alone
    would be (exact: the same operations on the same values)."""
    params, grads = _inputs(6)
    a = torch.tensor(params, requires_grad=True)
    b = torch.tensor(params, requires_grad=True)
    opt = make_optimizer("Adam", [a, b], LR, {"amsgrad": True})
    alone = torch.tensor(params, requires_grad=True)
    opt_alone = make_optimizer("Adam", [alone], LR, {"amsgrad": True})
    for i, g in enumerate(grads):
        a.grad = torch.tensor(g)
        b.grad = torch.tensor(g) if i % 3 else None
        opt.step()
        if i % 3:
            alone.grad = torch.tensor(g)
            opt_alone.step()
    assert opt.state[a]["step"] == STEPS and opt.state[b]["step"] == STEPS - 3
    assert torch.equal(b.detach(), alone.detach())


def test_optimizer_state_round_trips():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer("RMSprop", [p], LR, {"momentum": 0.5, "centered": True})
    p.grad = torch.full((3,), 0.5)
    opt.step()
    again = make_optimizer("RMSprop", [p], LR, {"momentum": 0.5, "centered": True})
    again.load_state_dict(opt.state_dict())
    assert set(again.state[p]) == {"step", "nu", "mu", "trace"}


def test_bad_specs_raise():
    p = [torch.zeros(1, requires_grad=True)]
    with pytest.raises(AttributeError):
        make_optimizer("Lion", p, LR)
    with pytest.raises(TypeError):
        make_optimizer("Adagrad", p, LR, {"betas": (0.9, 0.99)})
    with pytest.raises(TypeError):
        make_optimizer("Adam", p, LR, {"amsgrad": True, "nesterov": True})
