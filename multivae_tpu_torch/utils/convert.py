"""Weight transfer from the JAX package's parameter tree.

``params_from_jax`` maps the nested dict ``jax.tree.map(np.asarray,
model.params)`` of a ``multivae_tpu`` model to a ``state_dict`` of the
port's model of the same class and config:

- ``encoders/<m>/Dense_i`` and ``decoders/<m>/Dense_i`` become
  ``encoders.<m>.dense.<i>`` and ``decoders.<m>.dense.<i>``: the port's
  MLP nets keep their ``nn.Linear`` layers in a ``dense`` ModuleList in the
  order Flax creates them. A Dense kernel (in, out) becomes a Linear weight
  (out, in);
- ``model/<name>`` (e.g. ``prior_log_var``) becomes the top-level
  parameter ``<name>``.

Only numpy goes in; the JAX side of the conversion is the caller's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NET_GROUPS = ("encoders", "decoders")


def _dense_index(name: str) -> int:
    prefix, _, idx = name.partition("_")
    if prefix != "Dense" or not idx.isdigit():
        raise KeyError(f"Unsupported Flax layer {name!r}: only Dense_i "
                       "layers of the default MLP nets are mapped.")
    return int(idx)


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Nested numpy parameter tree -> torch ``state_dict``."""
    unknown = set(params) - set(_NET_GROUPS) - {"model"}
    if unknown:
        raise KeyError(f"Unsupported parameter groups: {sorted(unknown)}")
    state = {}
    for group in _NET_GROUPS:
        for mod, layers in params.get(group, {}).items():
            for name, leaf in layers.items():
                prefix = f"{group}.{mod}.dense.{_dense_index(name)}"
                state[prefix + ".weight"] = torch.tensor(
                    np.asarray(leaf["kernel"]).T.copy())
                state[prefix + ".bias"] = torch.tensor(
                    np.asarray(leaf["bias"]))
    for name, leaf in params.get("model", {}).items():
        state[name] = torch.tensor(np.asarray(leaf))
    return state
