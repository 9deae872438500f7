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

``param_dtype`` is the dtype of the parameters the model computes with:
float32, or bfloat16 inside a train step of the trainer's
``mixed_precision`` (which swaps bf16 copies in for the parameters). The
constants a loss builds and the noise ``draw_noise`` draws follow it, as
the JAX package's ``param_dtype`` and ``loc.dtype`` draws do.

Every subclass registers itself by class name on definition
(``get_model_class``, ``model_registry``), which ``AutoModel`` reads.

``push_to_hf_hub`` uploads the saved files and a model card to a Hugging
Face hub repo (creating it when the first commit fails), and
``load_from_hf_hub`` reads them back; ``huggingface_hub`` is imported
only there, and pickled custom architectures load only with
``allow_pickle=True``.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
from typing import Dict, Optional, Type

import torch
from torch import nn

from ...ops.gaussian import rsample_from_gaussian
from ...parallel.shard import NO_SHARD, DataShard
from ...utils.config import EnvironmentConfig, get_config_class

logger = logging.getLogger(__name__)

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

    @property
    def param_dtype(self) -> torch.dtype:
        """The compute dtype: the parameters' (JAX ``param_dtype``)."""
        return next(self.parameters()).dtype

    #: this process's part of a data-parallel step's global batch
    #: (``parallel/shard.py``); the trainer sets it around its steps
    data_shard: DataShard = NO_SHARD

    @contextlib.contextmanager
    def sharded(self, shard: Optional[DataShard]):
        """``data_shard`` set to ``shard`` inside the block (None: no
        change)."""
        if shard is None:
            yield
            return
        self.data_shard = shard
        try:
            yield
        finally:
            del self.data_shard

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None,
                   dtype: Optional[torch.dtype] = None):
        """Standard-normal noise of ``shape`` on the model's device, in
        ``dtype`` (default ``param_dtype``, so bf16 in a mixed-precision
        step): every sample the model draws comes from here, so a test can
        feed another package's noise."""
        return torch.randn(shape, generator=generator, device=self.device,
                           dtype=dtype or self.param_dtype)

    def draw_uniform(self, shape, generator: Optional[torch.Generator] = None,
                     dtype: Optional[torch.dtype] = None):
        """U[0, 1) draws of ``shape`` on the model's device in ``dtype``
        (default ``param_dtype``; JNF's HMC accept tests), a hook like
        ``draw_noise``."""
        return torch.rand(shape, generator=generator, device=self.device,
                          dtype=dtype or self.param_dtype)

    def noise_for(self, loc):
        """``draw_noise``, drawing in ``loc``'s dtype as JAX draws: the
        hook itself where that is ``param_dtype``, else with the dtype
        given (a loss that promoted ``loc`` to float32 under bf16, as
        MHVAE's and MoPoE's products of experts do)."""
        if loc.dtype == self.param_dtype:
            return self.draw_noise
        return functools.partial(self.draw_noise, dtype=loc.dtype)

    def _sample(self, mu, log_var, N: int = 1, return_mean: bool = False,
                flatten: bool = False, generator: Optional[torch.Generator] = None,
                row_blocks: int = 1):
        """``rsample_from_gaussian`` with its noise from ``draw_noise`` (none
        drawn with ``return_mean``); ``mu``'s first axis holds the rows, in
        ``row_blocks`` blocks."""
        noise = None
        if not return_mean:
            noise = self.data_shard.draw(self.noise_for(mu),
                                         mu.shape if N == 1 else (N, *mu.shape), generator,
                                         axis=-mu.dim(), blocks=row_blocks)
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

    # ------------------------------------------------------- HF hub (opt.)
    MODEL_CARD_TEMPLATE = """---
language: en
tags:
- multivae_tpu_torch
license: apache-2.0
---

### Downloading this model from the Hub
This model was trained with multivae_tpu_torch. It can be downloaded or
reloaded using the method `load_from_hf_hub`
```python
>>> from multivae_tpu_torch.models import AutoModel
>>> model = AutoModel.load_from_hf_hub(hf_hub_path="your_hf_username/repo_name")
```
"""

    @staticmethod
    def _hf_hub_is_available() -> bool:
        import importlib.util

        return importlib.util.find_spec("huggingface_hub") is not None

    def push_to_hf_hub(self, hf_hub_path: str):
        """Upload the saved model (``model_config.json``, ``model.pt``, a
        ``<group>.pkl`` per custom architecture, ``environment.json``) and a
        model card as ``README.md`` to the hub repo ``hf_hub_path``, which is
        created when the first commit fails. Needs ``huggingface_hub`` and
        a logged-in account."""
        if not self._hf_hub_is_available():
            raise ModuleNotFoundError(
                "`huggingface_hub` package must be installed to push your model to "
                "the HF hub. Run `python -m pip install huggingface_hub` and log in "
                "with `huggingface-cli login`.")
        import shutil
        import tempfile

        from huggingface_hub import CommitOperationAdd, HfApi

        logger.info("Uploading %s model to %s repo in HF hub...", self.model_name,
                    hf_hub_path)
        tempdir = tempfile.mkdtemp()
        try:
            self.save(tempdir)
            operations = [CommitOperationAdd(path_in_repo=f,
                                             path_or_fileobj=os.path.join(tempdir, f))
                          for f in os.listdir(tempdir)]
            card = os.path.join(tempdir, "model_card.md")
            with open(card, "w") as f:
                f.write(self.MODEL_CARD_TEMPLATE)
            operations.append(CommitOperationAdd(path_in_repo="README.md",
                                                 path_or_fileobj=card))
            api = HfApi()
            message = f"Uploading {self.model_name} in {hf_hub_path}"
            try:
                api.create_commit(commit_message=message, repo_id=hf_hub_path,
                                  operations=operations)
            except Exception:
                from huggingface_hub import create_repo

                repo_name = os.path.basename(os.path.normpath(hf_hub_path))
                logger.info("Creating %s in the HF hub since it does not exist...",
                            repo_name)
                create_repo(repo_id=repo_name)
                api.create_commit(commit_message=message, repo_id=hf_hub_path,
                                  operations=operations)
        finally:
            shutil.rmtree(tempdir)

    @classmethod
    def load_from_hf_hub(cls, hf_hub_path: str, allow_pickle: bool = False,
                         device="cuda") -> "BaseModel":
        """Download a model pushed with ``push_to_hf_hub`` and load it onto
        ``device``. Pickled custom architectures run code when loaded: they
        are refused unless ``allow_pickle=True``."""
        if not cls._hf_hub_is_available():
            raise ModuleNotFoundError(
                "`huggingface_hub` package must be installed to load models from "
                "the HF hub. Run `python -m pip install huggingface_hub`.")
        import json
        import tempfile

        from huggingface_hub import hf_hub_download

        logger.info("Downloading %s files for rebuilding...", hf_hub_path)
        tempdir = tempfile.mkdtemp()
        config_path = hf_hub_download(repo_id=hf_hub_path, filename="model_config.json",
                                      local_dir=tempdir)
        with open(config_path) as f:
            custom = json.load(f).get("custom_architectures", [])
        if custom and not allow_pickle:
            raise RuntimeError(
                "The model on the hub contains pickled custom architectures. Loading "
                "them executes arbitrary code; pass allow_pickle=True only if you "
                "trust the source.")
        hf_hub_download(repo_id=hf_hub_path, filename="model.pt", local_dir=tempdir)
        for arch in sorted(set(custom)):
            hf_hub_download(repo_id=hf_hub_path, filename=f"{arch}.pkl", local_dir=tempdir)
        return cls.load_from_folder(os.path.dirname(config_path), device=device)

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
