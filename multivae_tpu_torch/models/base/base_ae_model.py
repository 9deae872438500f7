"""BaseMultiVAE: the shared multimodal-VAE machinery that MMVAE uses.

Counterpart of ``multivae_tpu/models/base/base_ae_model.py``: the
constructor checks, ``set_rescale_factors``, ``set_decoders_dist``,
``encode_mod`` / ``decode_mod`` (any leading shape) and ``forward``.
``encode`` / ``decode`` / ``predict`` / the NLL estimators are not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...data.batch import MultimodalBatch, as_batch
from ...nn.default_architectures import BaseDictDecoders, BaseDictEncoders
from ...ops.dists import set_decoder_dist
from ...utils.device import resolve_device
from ...utils.model_output import ModelOutput
from .base_config import BaseMultiVAEConfig
from .base_model import BaseModel
from .step import StepInfo


class BaseMultiVAE(BaseModel):
    """Base class for multimodal VAE models.

    Args:
        model_config: a BaseMultiVAEConfig (or subclass).
        encoders: dict modality -> encoder ``nn.Module``. Defaults to MLP
            encoders built from ``model_config.input_dims``.
        decoders: dict modality -> decoder ``nn.Module``.
        seed: seed of the generator that initializes the default nets.
        device: where the model lives (default "cuda"; raises when CUDA
            is absent).
    """

    model_name = "BaseMultiVAE"

    def __init__(self, model_config: BaseMultiVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        super().__init__(model_config)
        self._device = resolve_device(device)
        self._seed = seed
        if model_config.use_remat:
            raise NotImplementedError(
                "use_remat (activation rematerialization) is not ported.")

        self.n_modalities = model_config.n_modalities
        self.input_dims = model_config.input_dims
        self.latent_dim = model_config.latent_dim
        self.use_likelihood_rescaling = model_config.uses_likelihood_rescaling
        self._check_input_dims(model_config)

        self._default_nets = []
        if encoders is None:
            if self.input_dims is None:
                raise AttributeError(
                    "Please provide encoders or input dims for the modalities "
                    "in the model_config.")
            encoders = BaseDictEncoders(self.input_dims, model_config.latent_dim)
            self._default_nets.append("encoders")
        else:
            model_config.custom_architectures.append("encoders")
        if decoders is None:
            if self.input_dims is None:
                raise AttributeError(
                    "Please provide decoders or input dims for the modalities "
                    "in the model_config.")
            decoders = BaseDictDecoders(self.input_dims, model_config.latent_dim)
            self._default_nets.append("decoders")
        else:
            model_config.custom_architectures.append("decoders")

        self.sanity_check(encoders, decoders)
        self.encoders = nn.ModuleDict(encoders)
        self.decoders = nn.ModuleDict(decoders)
        self.modalities_name = list(self.decoders.keys())
        self.rescale_factors = self.set_rescale_factors()

        if model_config.decoders_dist is None:
            model_config.decoders_dist = {k: "normal" for k in self.encoders}
        if model_config.decoder_dist_params is None:
            model_config.decoder_dist_params = {}
        self.set_decoders_dist(model_config.decoders_dist,
                               dict(model_config.decoder_dist_params))

    # ----------------------------------------------------------- validation
    def _check_input_dims(self, model_config):
        if (model_config.input_dims is not None
                and len(model_config.input_dims) != model_config.n_modalities):
            raise AttributeError(
                f"The provided number of input_dims "
                f"{len(model_config.input_dims)} doesn't match the number "
                f"of modalities ({model_config.n_modalities}) in model config")

    def sanity_check(self, encoders, decoders):
        """Coherence checks between encoders/decoders and the config."""
        if self.n_modalities != len(encoders):
            raise AttributeError(
                f"The provided number of encoders {len(encoders)} doesn't "
                f"match the number of modalities ({self.n_modalities}) in "
                "model config")
        if self.n_modalities != len(decoders):
            raise AttributeError(
                f"The provided number of decoders {len(decoders)} doesn't "
                f"match the number of modalities ({self.n_modalities}) in "
                "model config")
        if encoders.keys() != decoders.keys():
            raise AttributeError(
                "The names of the modalities in the encoders dict doesn't match "
                "the names of the modalities in the decoders dict.")
        for kind, nets in (("encoder", encoders), ("decoder", decoders)):
            for m, net in nets.items():
                if not isinstance(net, nn.Module):
                    raise AttributeError(
                        f"For modality {m}, the {kind} must be a "
                        f"torch.nn.Module (got {type(net)}).")
        if self.input_dims is not None and self.input_dims.keys() != encoders.keys():
            raise KeyError(
                f"The modalities names in model_config.input_dims: "
                f"{list(self.input_dims.keys())} do not match the "
                f"modalities names in encoders: {list(encoders.keys())}")

    def set_rescale_factors(self):
        """Per-modality reconstruction rescaling."""
        if self.use_likelihood_rescaling:
            if self.model_config.rescale_factors is not None:
                return dict(self.model_config.rescale_factors)
            if self.input_dims is None:
                raise AttributeError(
                    "inputs_dim is None but uses_likelihood_rescaling = True in "
                    "model_config. Please provide input_dims or rescale_factors.")
            sizes = {k: float(np.prod(self.input_dims[k])) for k in self.input_dims}
            max_dim = max(sizes.values())
            return {k: max_dim / sizes[k] for k in sizes}
        return {k: 1.0 for k in self.encoders}

    def set_decoders_dist(self, recon_dict, dist_params_dict):
        """Per-modality elementwise reconstruction log-prob closures."""
        self.recon_log_probs = {
            k: set_decoder_dist(recon_dict[k], dict(dist_params_dict.get(k, {})))
            for k in recon_dict
        }

    # ------------------------------------------------------- initialization
    def _init_extra_params(self):
        """Extra learnable tensors (prior params...): name -> Parameter."""
        return {}

    def init_params(self):
        """Draw the default nets' weights from ``torch.Generator(seed)`` (per
        modality: encoder, then decoder), register the extra parameters and
        move everything to the model's device. User-supplied nets keep their
        own weights."""
        generator = torch.Generator().manual_seed(self._seed)
        for mod in self.encoders:
            for group in self._default_nets:
                getattr(self, group)[mod].reset_parameters(generator)
        for name, param in self._init_extra_params().items():
            self.register_parameter(name, param)
        self.to(self._device)

    # -------------------------------------------------------------- compute
    def encode_mod(self, mod: str, x) -> ModelOutput:
        return self.encoders[mod](x)

    def decode_mod(self, mod: str, z):
        """Decoder output for ``mod``; ``z`` may have any leading shape."""
        return self.decoders[mod](z)["reconstruction"]

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Must return ModelOutput(loss, loss_sum, metrics)."""
        raise NotImplementedError

    def forward(self, inputs, epoch: int = 1,
                generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        """Loss on ``inputs`` (a batch, dataset slice or dict of arrays)."""
        batch = as_batch(inputs).to(self.device)
        step = StepInfo(
            epoch=epoch,
            batch_ratio=kwargs.get("batch_ratio", 0.0),
            dataset_size=kwargs.get("dataset_size", batch.n_samples),
        )
        return self.loss_function(batch, step, generator=generator)
