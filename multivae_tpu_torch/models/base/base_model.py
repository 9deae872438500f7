"""BaseModel: config plumbing, save/load, model registry.

Counterpart of ``multivae_tpu/models/base/base_model.py``. A model is an
``nn.Module``; its weights are its ``state_dict``, saved as ``model.pt``
beside ``model_config.json`` and ``environment.json`` (the JAX package
writes ``model.msgpack`` in the same layout). Custom architectures are
pickled per entry of ``model_config.custom_architectures``, as the JAX
package does with cloudpickle: a network group held in an ``nn.ModuleDict``
(``encoders``, ``decoders``, JNF's ``flows``) as a dict of modules, a
single module (``joint_encoder``, CVAE's ``encoder``) whole, and each is
given back to the constructor in that form. Loading them runs code from
the pickle, so load only folders you wrote.

Every subclass registers itself by class name on definition
(``get_model_class``, ``model_registry``), which ``AutoModel`` reads.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Type

import torch
from torch import nn

from ...ops.gaussian import rsample_from_gaussian
from ...utils.config import EnvironmentConfig, get_config_class

_MODEL_REGISTRY: Dict[str, Type["BaseModel"]] = {}


def get_model_class(name: str) -> Type["BaseModel"]:
    if name not in _MODEL_REGISTRY:
        raise NameError(
            f"Model class '{name}' is unknown. Registered: {sorted(_MODEL_REGISTRY)}"
        )
    return _MODEL_REGISTRY[name]


def model_registry() -> Dict[str, Type["BaseModel"]]:
    return dict(_MODEL_REGISTRY)


class BaseModel(nn.Module):
    """Root class of all models: holds the config and the modules."""

    model_name = "BaseModel"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _MODEL_REGISTRY[cls.__name__] = cls

    def __init__(self, model_config):
        super().__init__()
        self.model_config = model_config

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None):
        """Standard-normal noise of ``shape`` on the model's device: every
        sample the model draws comes from here, so a test can feed another
        package's noise."""
        return torch.randn(shape, generator=generator, device=self.device)

    def draw_uniform(self, shape, generator: Optional[torch.Generator] = None):
        """U[0, 1) draws of ``shape`` on the model's device (JNF's HMC
        accept tests), a hook like ``draw_noise``."""
        return torch.rand(shape, generator=generator, device=self.device)

    def _sample(self, mu, log_var, N: int = 1, return_mean: bool = False,
                flatten: bool = False, generator: Optional[torch.Generator] = None):
        """``rsample_from_gaussian`` with its noise from ``draw_noise`` (none
        drawn with ``return_mean``)."""
        noise = None
        if not return_mean:
            noise = self.draw_noise(mu.shape if N == 1 else (N, *mu.shape), generator)
        return rsample_from_gaussian(mu, log_var, N=N, return_mean=return_mean,
                                     flatten=flatten, noise=noise)

    # ------------------------------------------------------------ save/load
    def save(self, dir_path: str, state_dict: Optional[dict] = None):
        """Save the config, the weights (``state_dict``, default the live
        one) and any custom architectures."""
        os.makedirs(dir_path, exist_ok=True)
        env = EnvironmentConfig(
            python_version=f"{sys.version_info[0]}.{sys.version_info[1]}")
        env.save_json(dir_path, "environment")
        self.model_config.save_json(dir_path, "model_config")
        torch.save(self.state_dict() if state_dict is None else state_dict,
                   os.path.join(dir_path, "model.pt"))
        for arch_name in set(self.model_config.custom_architectures):
            arch = getattr(self, arch_name)
            torch.save(dict(arch) if isinstance(arch, nn.ModuleDict) else arch,
                       os.path.join(dir_path, f"{arch_name}.pkl"))

    @classmethod
    def _load_custom_architectures(cls, dir_path: str, config) -> dict:
        kwargs = {}
        for arch_name in set(config.custom_architectures):
            path = os.path.join(dir_path, f"{arch_name}.pkl")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"Missing custom architecture file {path} referenced by the "
                    "model config.")
            kwargs[arch_name] = torch.load(path, map_location="cpu",
                                           weights_only=False)
        return kwargs

    @classmethod
    def config_class(cls):
        return get_config_class(cls.__name__ + "Config")

    @classmethod
    def load_from_folder(cls, dir_path: str, device="cuda") -> "BaseModel":
        """Reload a model saved with ``save`` onto ``device``."""
        config_path = os.path.join(dir_path, "model_config.json")
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"Missing model config at {config_path}")
        weights_path = os.path.join(dir_path, "model.pt")
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"Missing model weights file {weights_path}")
        config = cls.config_class().from_json_file(config_path)
        custom = cls._load_custom_architectures(dir_path, config)
        # the constructor re-appends the custom architecture names
        config.custom_architectures = []
        model = cls(config, **custom, device=device)
        model.load_state_dict(torch.load(weights_path, map_location=model.device,
                                         weights_only=True))
        return model
