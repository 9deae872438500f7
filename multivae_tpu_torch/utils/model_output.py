"""Attribute-accessible output container (counterpart of
``multivae_tpu/utils/model_output.py``, without the JAX pytree
registration that eager PyTorch does not need)."""

from __future__ import annotations


class ModelOutput(dict):
    """A dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __repr__(self):
        inner = ", ".join(f"{k}={type(v).__name__}" for k, v in self.items())
        return f"ModelOutput({inner})"
