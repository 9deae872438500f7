"""CVAE: a conditional VAE that reconstructs one modality from the others.

Counterpart of ``multivae_tpu/models/cvae/cvae_model.py``:

- q(z | all modalities) from ``encoder`` (by default a
  ``MultipleHeadJointEncoder`` over MLP encoders of every modality);
- p(z | conditioning modalities) from the optional ``prior_network``, else
  N(0, I);
- ``decoder`` (by default a ``ConditionalDecoderMLP``) reconstructs the main
  modality from z and the conditioning modalities' data;
- the loss is the reference's batch mean: the reconstruction summed over
  the main modality's features and the KL, each averaged over the rows,
  the KL weighed by ``beta``.

The default nets are drawn from ``torch.Generator(seed)`` (encoder, then
decoder); user-supplied nets keep their weights and are recorded in
``custom_architectures`` for save/load.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ...data.batch import MultimodalBatch, as_batch
from ...nn.default_architectures import (
    BaseAEConfig,
    BaseDictEncoders,
    ConditionalDecoderMLP,
    MultipleHeadJointEncoder,
)
from ...ops.dists import set_decoder_dist
from ...ops.gaussian import kl_divergence, rsample_from_gaussian
from ...utils.device import resolve_device
from ...utils.model_output import ModelOutput
from ..base.base_model import BaseModel
from ..base.step import StepInfo
from .cvae_config import CVAEConfig


class CVAE(BaseModel):
    """Conditional Variational Autoencoder."""

    model_name = "CVAE"

    def __init__(self, model_config: CVAEConfig, encoder: nn.Module = None,
                 decoder: nn.Module = None, prior_network: nn.Module = None,
                 seed: int = 0, device="cuda"):
        super().__init__(model_config)
        self._device = resolve_device(device)
        self._seed = seed
        self.latent_dim = model_config.latent_dim
        self.main_modality = model_config.main_modality
        self.conditioning_modalities = list(model_config.conditioning_modalities)
        self.beta = model_config.beta
        self.recon_log_prob = set_decoder_dist(model_config.decoder_dist,
                                               dict(model_config.decoder_dist_params))
        self._default_nets = []
        nets = {"encoder": (encoder, self._default_encoder, "BaseJointEncoder"),
                "decoder": (decoder, self._default_decoder, "BaseConditionalDecoder")}
        for name, (net, default, contract) in nets.items():
            if net is None:
                net = default(model_config)
                self._default_nets.append(name)
            else:
                model_config.custom_architectures.append(name)
            if not isinstance(net, nn.Module):
                raise ValueError(f"The {name} must be a torch.nn.Module implementing "
                                 f"the {contract} contract")
            setattr(self, name, net)
        if prior_network is not None:
            if not isinstance(prior_network, nn.Module):
                raise ValueError("The prior network must be a torch.nn.Module "
                                 "implementing the BaseJointEncoder contract")
            model_config.custom_architectures.append("prior_network")
        self.prior_network = prior_network
        self.init_params()

    def _default_encoder(self, model_config):
        if model_config.input_dims is None:
            raise AttributeError(
                "No encoder was provided but model_config.input_dims is None. "
                "Please provide the input_dims of the model or an encoder "
                "architecture.")
        return MultipleHeadJointEncoder(
            BaseDictEncoders(model_config.input_dims, model_config.latent_dim),
            BaseAEConfig(latent_dim=model_config.latent_dim))

    def _default_decoder(self, model_config):
        if model_config.input_dims is None:
            raise AttributeError(
                "No decoder was provided but model_config.input_dims is None. "
                "Please provide the input_dims of the model or a decoder "
                "architecture.")
        dims = model_config.input_dims
        return ConditionalDecoderMLP(
            model_config.latent_dim, dims[model_config.main_modality],
            {m: dims[m] for m in model_config.conditioning_modalities})

    def init_params(self):
        """Draw the default nets' weights from ``torch.Generator(seed)`` and
        move the model to its device."""
        generator = torch.Generator().manual_seed(self._seed)
        for name in self._default_nets:
            getattr(self, name).reset_parameters(generator)
        self.to(self._device)

    # ----------------------------------------------------------------- loss
    def _cond(self, data: dict) -> dict:
        return {m: data[m] for m in self.conditioning_modalities}

    def _prior(self, cond: dict, like: torch.Tensor):
        if self.prior_network is None:
            zeros = torch.zeros(like.shape[0], self.latent_dim, device=like.device,
                                dtype=like.dtype)
            return zeros, zeros
        p = self.prior_network(cond)
        return p["embedding"], p["log_covariance"]

    def loss_function(self, batch: MultimodalBatch, step: Optional[StepInfo] = None,
                      generator: Optional[torch.Generator] = None) -> ModelOutput:
        out = self.encoder(batch.data)
        mu, log_var = out["embedding"], out["log_covariance"]
        shard = self.data_shard
        z = rsample_from_gaussian(mu, log_var, noise=shard.draw(self.draw_noise, mu.shape,
                                                                generator))
        cond = self._cond(batch.data)
        prior_mu, prior_lv = self._prior(cond, mu)
        recon = self.decoder(z, cond)["reconstruction"]
        lp = -self.recon_log_prob(recon, batch.data[self.main_modality])
        w = batch.weights
        n_data = shard.total(w.sum()).clamp_min(1.0)
        recon_loss = (lp.reshape(lp.shape[0], -1) * w[:, None]).sum() / n_data
        kl = (kl_divergence(mu, log_var, prior_mu, prior_lv) * w).sum() / n_data
        loss = recon_loss + kl * self.beta
        return ModelOutput(loss=loss, loss_sum=loss * n_data,
                           metrics={"kl": kl, "recon_loss": recon_loss})

    def forward(self, inputs, epoch: int = 1,
                generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        batch = as_batch(inputs).to(self.device)
        return self.loss_function(batch, StepInfo(epoch=epoch), generator=generator)

    # ------------------------------------------------------------ inference
    @staticmethod
    def _tile(cond: dict, N: int, flatten: bool) -> dict:
        """Conditioning data for N samples a row: (N, B, ...), or (N * B,
        ...) with ``flatten``."""
        if N == 1:
            return dict(cond)
        if flatten:
            return {m: torch.cat([v] * N) for m, v in cond.items()}
        return {m: v.expand(N, *v.shape) for m, v in cond.items()}

    def encode(self, inputs, N: int = 1, return_mean: bool = False, flatten: bool = False,
               generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        """z ~ q(z | all modalities) and the conditioning data to decode it
        with, tiled to z's leading shape."""
        batch = as_batch(inputs).to(self.device)
        out = self.encoder(batch.data)
        z = self._sample(out["embedding"], out["log_covariance"], N, return_mean,
                         flatten, generator)
        return ModelOutput(z=z, cond_mod_data=self._tile(self._cond(batch.data), N, flatten))

    def decode(self, embedding: ModelOutput, **kwargs) -> ModelOutput:
        """The main modality from z, (B, D) or (N, B, D), and its
        conditioning data."""
        z, cond = embedding["z"], embedding["cond_mod_data"]
        if z.ndim == 3:
            N, B = z.shape[:2]
            recon = self.decoder(z.reshape(N * B, -1),
                                 {m: v.reshape(N * B, *v.shape[2:])
                                  for m, v in cond.items()})["reconstruction"]
            return ModelOutput(reconstruction=recon.reshape(N, B, *recon.shape[1:]))
        return ModelOutput(reconstruction=self.decoder(z, cond)["reconstruction"])

    def generate_from_prior(self, cond_mod_data: Dict, N: int = 1, flatten: bool = False,
                            generator: Optional[torch.Generator] = None,
                            **kwargs) -> ModelOutput:
        """z from the (conditional) prior of ``cond_mod_data``'s rows."""
        cond = {m: torch.as_tensor(v, device=self.device) for m, v in cond_mod_data.items()}
        prior_mu, prior_lv = self._prior(cond, next(iter(cond.values())))
        z = self._sample(prior_mu, prior_lv, N, flatten=flatten, generator=generator)
        return ModelOutput(z=z, cond_mod_data=self._tile(cond, N, flatten))

    def predict(self, inputs, cond_mod: Union[str, list] = "all", N: int = 1,
                generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        """The main modality, encoded from all modalities (``cond_mod``
        "all", the main one, or all listed) or drawn from the prior of the
        conditioning modalities (``cond_mod`` those)."""
        batch = as_batch(inputs).to(self.device)
        everything = set([self.main_modality] + self.conditioning_modalities)
        if cond_mod == "all" or set(cond_mod) in ({self.main_modality}, everything):
            embeddings = self.encode(batch, N=N, generator=generator, **kwargs)
        elif set(cond_mod) == set(self.conditioning_modalities):
            embeddings = self.generate_from_prior(self._cond(batch.data), N=N,
                                                  generator=generator, **kwargs)
        else:
            raise ValueError("The conditioning modalities must be either 'all' or the "
                             "list of conditioning modalities")
        return ModelOutput(**{self.main_modality:
                              self.decode(embeddings)["reconstruction"]})
