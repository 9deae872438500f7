"""AutoModel: reload any model from a folder by its config name.

Counterpart of ``multivae_tpu/models/auto_model/auto_model.py``: every
``BaseModel`` subclass registers itself on definition, and the model class
is the config class name minus its "Config" suffix. Reloading from the
Hugging Face hub (``load_from_hf_hub``) is not part of the port yet.
"""

from __future__ import annotations

import json
import os

from ..base.base_model import get_model_class


class AutoModel:
    """Reload any model of the port from a save folder."""

    @classmethod
    def load_from_folder(cls, dir_path: str, device="cuda"):
        """Reload the model saved in ``dir_path`` onto ``device`` (default
        "cuda"; raises when CUDA is absent). The folder holds
        ``model_config.json`` and ``model.pt`` (and a ``<group>.pkl`` per
        custom architecture)."""
        config_path = os.path.join(dir_path, "model_config.json")
        with open(config_path) as f:
            config_name = json.load(f)["name"]

        # make sure every model class is registered
        from ... import models  # noqa: F401

        if not config_name.endswith("Config"):
            raise NameError(
                f"Cannot infer the model class from config name "
                f"'{config_name}'."
            )
        model_name = config_name[: -len("Config")]
        try:
            model_cls = get_model_class(model_name)
        except NameError as e:
            raise NameError(
                f"Unknown model name '{model_name}' read from "
                f"{config_path}. Check that the folder was saved with a "
                "multivae_tpu_torch model."
            ) from e
        return model_cls.load_from_folder(dir_path, device=device)
