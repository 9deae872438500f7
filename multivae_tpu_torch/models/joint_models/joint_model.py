"""BaseJointModel: models with a joint encoder over all modalities.

Counterpart of ``multivae_tpu/models/joint_models/joint_model.py``: a
``joint_encoder`` net (by default a ``MultipleHeadJointEncoder`` over its
own copies of the model's encoders, seeded after them; a user's net is
recorded in ``custom_architectures``), the refusal of incomplete data in
``forward``, ``encode`` and ``compute_joint_nll``, and the K-sample joint
NLL from the joint encoder's Gaussian posterior.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...data.batch import MultimodalBatch, as_batch
from ...nn.default_architectures import BaseAEConfig, MultipleHeadJointEncoder
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import BaseMultiVAE
from .joint_model_config import BaseJointModelConfig


class BaseJointModel(BaseMultiVAE):
    """Base class of the models with a joint encoder."""

    model_name = "BaseJointModel"

    def __init__(self, model_config: BaseJointModelConfig, encoders: dict = None,
                 decoders: dict = None, joint_encoder: nn.Module = None, seed: int = 0,
                 device="cuda"):
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)
        self._default_joint_encoder = joint_encoder is None
        if joint_encoder is None:
            joint_encoder = self.default_joint_encoder(model_config)
        else:
            self.model_config.custom_architectures.append("joint_encoder")
        if not isinstance(joint_encoder, nn.Module):
            raise AttributeError(
                "The joint encoder must be a torch.nn.Module implementing the "
                "BaseJointEncoder contract (dict of modalities -> "
                "ModelOutput(embedding, log_covariance)).")
        self.joint_encoder = joint_encoder

    def default_joint_encoder(self, model_config):
        return MultipleHeadJointEncoder(
            dict(self.encoders), BaseAEConfig(latent_dim=model_config.latent_dim))

    def _reset_extra_nets(self, generator: torch.Generator):
        if self._default_joint_encoder:
            self.joint_encoder.reset_parameters(generator)

    def encode_joint(self, data: dict) -> ModelOutput:
        return self._remat(self.joint_encoder, data)

    def _reject_incomplete(self, inputs):
        incomplete = (inputs.incomplete if isinstance(inputs, MultimodalBatch)
                      else getattr(inputs, "masks", None) is not None)
        if incomplete:
            raise AttributeError(
                "The inputs have masks but this model is not compatible with "
                "incomplete datasets.")

    def encode(self, inputs, cond_mod="all", N: int = 1, return_mean: bool = False,
               **kwargs) -> ModelOutput:
        self._reject_incomplete(inputs)
        return super().encode(inputs, cond_mod, N, return_mean=return_mean, **kwargs)

    def forward(self, inputs, epoch: int = 1,
                generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        self._reject_incomplete(inputs)
        return super().forward(inputs, epoch=epoch, generator=generator, **kwargs)

    @torch.no_grad()
    def compute_joint_nll(self, inputs, K: int = 1000, batch_size_K: int = 100,
                          generator: Optional[torch.Generator] = None):
        """K-sample IWAE estimate of -sum_rows ln p(X) with the joint
        encoder's posterior as the importance distribution."""
        self._reject_incomplete(inputs)
        batch = as_batch(inputs).to(self.device)
        out = self.encode_joint(batch.data)
        return self._gaussian_iwae_joint_nll(batch, out["embedding"],
                                             out["log_covariance"], K, batch_size_K,
                                             generator)
