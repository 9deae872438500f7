"""AutoConfig: reload any config from its JSON "name" field.

Counterpart of ``multivae_tpu/models/auto_model/auto_config.py``: every
``BaseConfig`` subclass registers itself on definition, and the ``name``
field of the file picks the class.
"""

from __future__ import annotations

import json

from ...utils.config import get_config_class


class AutoConfig:
    """Dispatches config reloading on the JSON ``name`` field."""

    @classmethod
    def from_json_file(cls, json_path: str):
        with open(json_path) as f:
            name = json.load(f)["name"]
        # make sure every model config class is registered
        from ... import models  # noqa: F401

        return get_config_class(name).from_json_file(json_path)
