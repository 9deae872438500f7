"""Optimizer and LR-scheduler factories from config strings.

Counterpart of ``multivae_tpu/trainers/base/optim.py``: the same whitelist
of optimizer names and parameter names, computing the JAX package's
(optax's) update for each. The torch spellings the port also accepts are
kept: ``betas`` for ``b1``/``b2``, RMSprop's ``alpha`` for ``decay``,
``amsgrad``, and the L2 ``weight_decay``/``lr_decay``/``dampening`` options
torch's classes have.

Where a ``torch.optim`` class computes optax's update it is used: Adam,
AdamW, Adadelta, SGD, Adamax and RAdam with their plain options (AdamW
with optax's default ``weight_decay`` of 1e-4). ``OptaxRule`` computes the
rest: ``optax.amsgrad`` (the max of the bias-corrected second moment),
optax's ``eps_root``, Adam's ``nesterov`` and RAdam's ``threshold``, and
optax's Adagrad and RMSprop (their defaults, and ``eps`` inside the square
root). Schedulers are ``torch.optim.lr_scheduler`` classes by name, stepped
once per epoch.

``make_capturable`` readies an optimizer for CUDA graph capture (the
trainer's ``steps_per_execution``): the step counts live on the device and
the bias corrections are tensor ops on them, and each learning rate is a
0-d device tensor that the schedulers fill in place. SGD has no such mode:
its learning rate stays a number, which a graph bakes in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_ADAM_KEYS = {"b1", "b2", "eps", "eps_root", "weight_decay"}
# name -> (the JAX whitelist plus the torch spellings, optax's defaults)
_OPTIMIZERS = {
    "Adam": (_ADAM_KEYS | {"nesterov", "amsgrad"}, {}),
    "AdamW": (_ADAM_KEYS | {"nesterov", "amsgrad"}, dict(weight_decay=1e-4)),
    "Adagrad": ({"eps", "initial_accumulator_value", "weight_decay", "lr_decay"},
                dict(eps=1e-7, initial_accumulator_value=0.1)),
    "Adadelta": ({"rho", "eps", "weight_decay"}, dict(rho=0.9, eps=1e-6)),
    "SGD": ({"momentum", "nesterov", "dampening", "weight_decay"}, {}),
    "RMSprop": ({"decay", "eps", "momentum", "centered", "initial_scale",
                 "weight_decay"}, dict(decay=0.9, eps=1e-8)),
    "Adamax": ({"b1", "b2", "eps", "weight_decay"}, {}),
    "RAdam": (_ADAM_KEYS | {"threshold"}, {}),
}

_SCHEDULERS = ("StepLR", "MultiStepLR", "ExponentialLR", "LinearLR",
               "ConstantLR", "PolynomialLR", "CosineAnnealingLR",
               "CosineAnnealingWarmRestarts", "ReduceLROnPlateau")


def _add_scaled_(xs, ys, c):
    """xs += c * ys for a number or a 0-d tensor ``c``."""
    if isinstance(c, torch.Tensor):
        torch._foreach_add_(xs, torch._foreach_mul(ys, c))
    else:
        torch._foreach_add_(xs, ys, alpha=c)


def _adam_rule(ps, gs, states, h, t):
    """optax ``scale_by_adam`` / ``scale_by_amsgrad`` / ``scale_by_radam``
    times -lr, with torch's coupled ``weight_decay`` for Adam and RAdam and
    optax's decoupled one (``add_decayed_weights``) for AdamW; over the
    parameters ``ps`` at step ``t`` (a number, or a 0-d device tensor when
    capturable) with ``torch._foreach_*`` ops."""
    b1, b2 = h["b1"], h["b2"]
    if h["weight_decay"] and not h["decoupled"]:
        gs = torch._foreach_add(gs, ps, alpha=h["weight_decay"])
    for p, state in zip(ps, states):
        if "mu" not in state:
            state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            if h["amsgrad"]:
                state["nu_max"] = torch.zeros_like(p)
    mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, gs, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
    if h["nesterov"]:
        mu_hat = torch._foreach_mul(mus, b1 / (1 - b1 ** (t + 1)))
        _add_scaled_(mu_hat, gs, (1 - b1) / (1 - b1 ** t))
    else:
        mu_hat = torch._foreach_div(mus, 1 - b1 ** t)
    nu_hat = torch._foreach_div(nus, 1 - b2 ** t)
    if h["amsgrad"]:
        nu_hat = [s["nu_max"] for s in states]
        torch._foreach_maximum_(nu_hat, torch._foreach_div(nus, 1 - b2 ** t))
    denom = torch._foreach_add(nu_hat, h["eps_root"])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, h["eps"])
    update = torch._foreach_div(mu_hat, denom)
    if h["threshold"] is not None:   # RAdam: rectify while the variance is tractable
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        if isinstance(ro, torch.Tensor):
            rect = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                              / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            keep = ro >= h["threshold"]
            update = [torch.where(keep, u * rect, m) for u, m in zip(update, mu_hat)]
        elif ro >= h["threshold"]:
            torch._foreach_mul_(update, math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
        else:
            update = mu_hat
    if h["weight_decay"] and h["decoupled"]:
        torch._foreach_add_(update, ps, alpha=h["weight_decay"])
    torch._foreach_mul_(update, -h["lr"])
    return update


def _each(rule):
    """A rule over one parameter, ``rule(p, g, state, h, t)``, as a rule
    over the list."""
    def over(ps, gs, states, h, t):
        return [rule(p, g, state, h, t) for p, g, state in zip(ps, gs, states)]
    return over


def _adagrad_rule(p, g, state, h, t):
    """optax ``scale_by_rss`` (eps inside the square root, accumulator from
    ``initial_accumulator_value``) with torch's ``weight_decay`` and
    ``lr_decay``."""
    if h["weight_decay"]:
        g = g + h["weight_decay"] * p
    if "sum" not in state:
        state["sum"] = torch.full_like(p, h["initial_accumulator_value"])
    acc = state["sum"].addcmul_(g, g)
    scale = torch.where(acc > 0, torch.rsqrt(acc + h["eps"]), 0.0)
    lr = h["lr"] / (1 + (t - 1) * h["lr_decay"])
    return -lr * scale * g


def _rmsprop_rule(p, g, state, h, t):
    """optax ``rmsprop``: ``scale_by_rms`` or ``scale_by_stddev`` (eps inside
    the square root, second moment from ``initial_scale``), then -lr, then
    the momentum trace; with torch's ``weight_decay``."""
    decay = h["decay"]
    if h["weight_decay"]:
        g = g + h["weight_decay"] * p
    if "nu" not in state:
        state["nu"] = torch.full_like(p, h["initial_scale"])
    nu = state["nu"].mul_(decay).addcmul_(g, g, value=1 - decay)
    if h["centered"]:
        mu = state.setdefault("mu", torch.zeros_like(p)).mul_(decay).add_(
            g, alpha=1 - decay)
        nu = nu - mu * mu
    update = -h["lr"] * torch.rsqrt(nu + h["eps"]) * g
    if h["momentum"]:
        if "trace" not in state:
            state["trace"] = update
        else:   # in place: a captured graph reads the trace where it was
            update = state["trace"].mul_(h["momentum"]).add_(update)
    return update


class OptaxRule(torch.optim.Optimizer):
    """An optax update rule as a ``torch.optim.Optimizer``: the parameters
    of a group that have a gradient, taken together where they are at the
    same step t (counted from 1 in ``state["step"]``), get
    ``rule(params, grads, states, group, t)``, the updates to add.

    A ``capturable`` group keeps ``state["step"]`` as a 0-d float32 tensor
    on the parameter's device, handed to the rule as t, and counts the
    steps the host has run in ``state["host_step"]``, by which it groups
    the parameters (a captured graph repeats the grouping of its capture).
    """

    def __init__(self, params, rule, lr: float, capturable: bool = False, **hyper):
        super().__init__(params, dict(lr=lr, capturable=capturable, **hyper))
        self.rule = rule

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            capturable = group.get("capturable", False)
            by_step = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if capturable:
                    if "step" not in state:
                        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["host_step"] = state.get("host_step", 0) + 1
                    by_step.setdefault(state["host_step"], []).append(p)
                else:
                    state["step"] = state.get("step", 0) + 1
                    by_step.setdefault(state["step"], []).append(p)
            for t, ps in by_step.items():
                states = [self.state[p] for p in ps]
                if capturable:
                    steps = [s["step"] for s in states]
                    torch._foreach_add_(steps, 1.0)
                    t = steps[0]
                updates = self.rule(ps, [p.grad for p in ps], states, group, t)
                torch._foreach_add_(ps, updates)
        return loss


def _translate(optimizer_cls: str, params: dict) -> dict:
    out = dict(params)
    if "betas" in out:
        out["b1"], out["b2"] = out.pop("betas")
    if optimizer_cls == "RMSprop" and "alpha" in out:
        out["decay"] = out.pop("alpha")
    return out


def _build(name: str, parameters, lr: float, p: dict):
    betas = (p.pop("b1", 0.9), p.pop("b2", 0.999))
    eps = p.pop("eps", 1e-8)
    if name in ("Adam", "AdamW", "RAdam"):
        h = dict(b1=betas[0], b2=betas[1], eps=eps, eps_root=p.pop("eps_root", 0.0),
                 weight_decay=p.pop("weight_decay", 0.0),
                 nesterov=p.pop("nesterov", False),
                 amsgrad=p.pop("amsgrad", False), decoupled=name == "AdamW",
                 threshold=p.pop("threshold", 5.0) if name == "RAdam" else None)
        if h["amsgrad"] and h["nesterov"]:
            raise TypeError("amsgrad does not take nesterov (optax.amsgrad has "
                            "no such option).")
        if not (h["eps_root"] or h["nesterov"] or h["amsgrad"]
                or (name == "RAdam" and h["threshold"] != 5.0)):
            ctor = {"Adam": torch.optim.Adam, "AdamW": torch.optim.AdamW,
                    "RAdam": torch.optim.RAdam}[name]
            return ctor(parameters, lr=lr, betas=betas, eps=eps,
                        weight_decay=h["weight_decay"])
        return OptaxRule(parameters, _adam_rule, lr, **h)
    if name == "Adagrad":
        return OptaxRule(parameters, _each(_adagrad_rule), lr, eps=eps,
                         initial_accumulator_value=p["initial_accumulator_value"],
                         weight_decay=p.get("weight_decay", 0.0),
                         lr_decay=p.get("lr_decay", 0.0))
    if name == "RMSprop":
        return OptaxRule(parameters, _each(_rmsprop_rule), lr, eps=eps, decay=p["decay"],
                         centered=p.get("centered", False),
                         momentum=p.get("momentum") or 0.0,
                         initial_scale=p.get("initial_scale", 0.0),
                         weight_decay=p.get("weight_decay", 0.0))
    if name == "Adamax":
        return torch.optim.Adamax(parameters, lr=lr, betas=betas, eps=eps, **p)
    if name == "Adadelta":
        return torch.optim.Adadelta(parameters, lr=lr, eps=eps, **p)
    return torch.optim.SGD(parameters, lr=lr, **{**p, "momentum": p.get("momentum") or 0})


def make_optimizer(optimizer_cls: str, parameters, learning_rate: float,
                   optimizer_params: Optional[dict] = None):
    """Build the optimizer named ``optimizer_cls`` over ``parameters``.

    Raises AttributeError on unknown names and TypeError on bad params.
    """
    if optimizer_cls not in _OPTIMIZERS:
        raise AttributeError(
            f"Unable to build `{optimizer_cls}` optimizer. Available "
            f"optimizers: {sorted(_OPTIMIZERS)}")
    allowed, defaults = _OPTIMIZERS[optimizer_cls]
    params = _translate(optimizer_cls, optimizer_params or {})
    unknown = set(params) - allowed
    if unknown:
        raise TypeError(
            f"Error in optimizer's parameters. Unknown parameters {unknown} "
            f"for `{optimizer_cls}` (allowed: {sorted(allowed)}).")
    return _build(optimizer_cls, parameters, learning_rate, {**defaults, **params})


def make_capturable(optimizer):
    """Ready ``optimizer`` (built by ``make_optimizer``, maybe loaded from a
    state dict) for CUDA graph capture, in place: every group that has a
    ``capturable`` mode gets it, its learning rate becomes a 0-d float32
    tensor on its parameters' device (the schedulers then ``fill_`` it)
    and its step counts device tensors. SGD's groups, which have no such
    mode, are left as they are."""
    for group in optimizer.param_groups:
        if "capturable" not in group:
            continue
        group["capturable"] = True
        device = group["params"][0].device
        if not (isinstance(group["lr"], torch.Tensor) and group["lr"].device == device):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            step = state.get("step")
            if step is None or (isinstance(step, torch.Tensor) and step.device == p.device):
                continue
            if isinstance(optimizer, OptaxRule):
                state["host_step"] = int(step)
            state["step"] = torch.tensor(float(step), dtype=torch.float32, device=p.device)
    return optimizer


def make_scheduler(scheduler_cls: Optional[str], optimizer,
                   scheduler_params: Optional[dict] = None):
    """Build a ``torch.optim.lr_scheduler`` scheduler by name, or None."""
    if scheduler_cls is None:
        return None
    if scheduler_cls not in _SCHEDULERS:
        raise AttributeError(
            f"Unable to build `{scheduler_cls}` scheduler. Available "
            f"schedulers: {sorted(_SCHEDULERS)}")
    ctor = getattr(torch.optim.lr_scheduler, scheduler_cls)
    try:
        return ctor(optimizer, **(scheduler_params or {}))
    except TypeError as e:
        raise TypeError(
            f"Error in scheduler's parameters for `{scheduler_cls}`: {e}") from e


def check_specs(optimizer_cls: str, learning_rate: float,
                optimizer_params: Optional[dict], scheduler_cls: Optional[str],
                scheduler_params: Optional[dict]):
    """Validate the optimizer and scheduler specs on a throwaway parameter."""
    opt = make_optimizer(optimizer_cls, [torch.zeros(1, requires_grad=True)],
                         learning_rate, optimizer_params)
    make_scheduler(scheduler_cls, opt, scheduler_params)
