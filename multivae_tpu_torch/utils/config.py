"""Config base: stdlib dataclasses with JSON round-trip and a name registry.

Counterpart of ``multivae_tpu/utils/config.py``. ``to_dict`` embeds a
``"name"`` field (the config class name) and the same field names as the
JAX package, so a ``model_config.json`` written by either package loads in
the other. Subclasses are ``@dataclass``-decorated; registration happens in
``__init_subclass__``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Type

_CONFIG_REGISTRY: Dict[str, Type] = {}


def get_config_class(name: str):
    if name not in _CONFIG_REGISTRY:
        raise NameError(
            f"Config class '{name}' is not registered. Known configs: "
            f"{sorted(_CONFIG_REGISTRY)}"
        )
    return _CONFIG_REGISTRY[name]


def _jsonable(obj: Any) -> Any:
    """Recursively convert to JSON-serializable structures."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return obj


@dataclasses.dataclass
class BaseConfig:
    """Base class for model / trainer configs: ``to_dict``,
    ``to_json_string``, ``save_json``, ``from_dict``, ``from_json_file``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _CONFIG_REGISTRY[cls.__name__] = cls

    @property
    def name(self) -> str:
        return self.__class__.__name__

    def to_dict(self) -> dict:
        d = {"name": self.__class__.__name__}
        for f in dataclasses.fields(self):
            d[f.name] = _jsonable(getattr(self, f.name))
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save_json(self, dir_path: str, filename: str) -> None:
        os.makedirs(dir_path, exist_ok=True)
        if not filename.endswith(".json"):
            filename = filename + ".json"
        with open(os.path.join(dir_path, filename), "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_dict(cls, config_dict: dict) -> "BaseConfig":
        d = dict(config_dict)
        d.pop("name", None)
        return cls(**d)

    @classmethod
    def from_json_file(cls, json_path: str) -> "BaseConfig":
        with open(json_path) as f:
            d = json.load(f)
        target = _CONFIG_REGISTRY.get(d.get("name", cls.__name__), cls)
        return target.from_dict(d)


_CONFIG_REGISTRY[BaseConfig.__name__] = BaseConfig


@dataclasses.dataclass
class EnvironmentConfig(BaseConfig):
    """Records the python version used when saving a model."""

    python_version: str = "3.12"
