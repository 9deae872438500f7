"""AutoModel: reload any model from a folder by its config name.

Counterpart of ``multivae_tpu/models/auto_model/auto_model.py``: every
``BaseModel`` subclass registers itself on definition, and the model class
is the config class name minus its "Config" suffix, read from a save
folder or from a Hugging Face hub repo (``load_from_hf_hub``).
"""

from __future__ import annotations

import json
import os

from ..base.base_model import get_model_class


class AutoModel:
    """Reload any model of the port from a save folder."""

    @staticmethod
    def _model_class(config_name: str, source: str):
        # make sure every model class is registered
        from ... import models  # noqa: F401

        if not config_name.endswith("Config"):
            raise NameError(
                f"Cannot infer the model class from config name "
                f"'{config_name}'."
            )
        model_name = config_name[: -len("Config")]
        try:
            return get_model_class(model_name)
        except NameError as e:
            raise NameError(
                f"Unknown model name '{model_name}' read from "
                f"{source}. Check that the folder was saved with a "
                "multivae_tpu_torch model."
            ) from e

    @classmethod
    def load_from_folder(cls, dir_path: str, device="cuda"):
        """Reload the model saved in ``dir_path`` onto ``device`` (default
        "cuda"; raises when CUDA is absent). The folder holds
        ``model_config.json`` and ``model.pt`` (and a ``<group>.pkl`` per
        custom architecture)."""
        config_path = os.path.join(dir_path, "model_config.json")
        with open(config_path) as f:
            config_name = json.load(f)["name"]
        return cls._model_class(config_name, config_path).load_from_folder(
            dir_path, device=device)

    @classmethod
    def load_from_hf_hub(cls, hf_hub_path: str, allow_pickle: bool = False,
                         device="cuda"):
        """Reload the model pushed to the hub repo ``hf_hub_path`` (by
        ``push_to_hf_hub``) onto ``device``, dispatching on its config's
        name; pickled custom architectures need ``allow_pickle=True``."""
        import tempfile

        from huggingface_hub import hf_hub_download

        config_path = hf_hub_download(repo_id=hf_hub_path, filename="model_config.json",
                                      local_dir=tempfile.mkdtemp())
        with open(config_path) as f:
            config_name = json.load(f)["name"]
        return cls._model_class(config_name, hf_hub_path).load_from_hf_hub(
            hf_hub_path, allow_pickle=allow_pickle, device=device)
