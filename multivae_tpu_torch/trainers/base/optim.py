"""Optimizer and LR-scheduler factories from config strings.

Counterpart of ``multivae_tpu/trainers/base/optim.py``: the same
whitelist of optimizer names, built here as ``torch.optim`` classes. The
parameter names are torch's; the optax spellings the JAX package also
accepts (``b1``/``b2`` for ``betas``, RMSprop's ``decay`` for ``alpha``)
are translated. Schedulers are ``torch.optim.lr_scheduler`` classes by
name, stepped once per epoch.
"""

from __future__ import annotations

from typing import Optional

import torch

_OPTIMIZERS = {
    "Adam": (torch.optim.Adam, {"betas", "eps", "weight_decay", "amsgrad"}),
    "AdamW": (torch.optim.AdamW, {"betas", "eps", "weight_decay", "amsgrad"}),
    "Adagrad": (torch.optim.Adagrad, {"eps", "initial_accumulator_value",
                                      "weight_decay", "lr_decay"}),
    "Adadelta": (torch.optim.Adadelta, {"rho", "eps", "weight_decay"}),
    "SGD": (torch.optim.SGD, {"momentum", "nesterov", "dampening",
                              "weight_decay"}),
    "RMSprop": (torch.optim.RMSprop, {"alpha", "eps", "momentum", "centered",
                                      "weight_decay"}),
    "Adamax": (torch.optim.Adamax, {"betas", "eps", "weight_decay"}),
    "RAdam": (torch.optim.RAdam, {"betas", "eps", "weight_decay"}),
}

_SCHEDULERS = ("StepLR", "MultiStepLR", "ExponentialLR", "LinearLR",
               "ConstantLR", "PolynomialLR", "CosineAnnealingLR",
               "CosineAnnealingWarmRestarts", "ReduceLROnPlateau")


def _translate_optax_params(optimizer_cls: str, params: dict) -> dict:
    out = dict(params)
    if "b1" in out or "b2" in out:
        out["betas"] = (out.pop("b1", 0.9), out.pop("b2", 0.999))
    if optimizer_cls == "RMSprop" and "decay" in out:
        out["alpha"] = out.pop("decay")
    return out


def make_optimizer(optimizer_cls: str, parameters, learning_rate: float,
                   optimizer_params: Optional[dict] = None):
    """Build a ``torch.optim`` optimizer by name over ``parameters``.

    Raises AttributeError on unknown names and TypeError on bad params.
    """
    if optimizer_cls not in _OPTIMIZERS:
        raise AttributeError(
            f"Unable to build `{optimizer_cls}` optimizer. Available "
            f"optimizers: {sorted(_OPTIMIZERS)}")
    ctor, allowed = _OPTIMIZERS[optimizer_cls]
    params = _translate_optax_params(optimizer_cls, optimizer_params or {})
    unknown = set(params) - allowed
    if unknown:
        raise TypeError(
            f"Error in optimizer's parameters. Unknown parameters {unknown} "
            f"for `{optimizer_cls}` (allowed: {sorted(allowed)}).")
    return ctor(parameters, lr=learning_rate, **params)


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
