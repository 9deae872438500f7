"""MAF sampler: one masked autoregressive flow fitted per latent space.

Counterpart of ``multivae_tpu/samplers/maf_sampler/maf_sampler.py``:

- one flow per latent space: ``shared`` (latent_dim), plus one per
  modality's private space (``style_dims``) for a multi-latent model;
  each ``fit`` draws their weights, Glorot-uniform, from
  ``torch.Generator().manual_seed(seed)``, the flows in order;
- the fit: the JAX package's plan, ``np.random.default_rng(0)``'s
  permutation for each epoch cut in batches, the last one zero-padded with
  zero weights so that its loss is the exact mean over its rows; the loss
  is the mean negative ``log_prob``; Adam at ``learning_rate``; the last
  step's loss is logged and kept in ``last_loss``;
- ``sample``: u ~ N(0, I) (through ``draw_noise``, a hook) pushed through
  ``inverse``;
- ``save`` writes each flow's ``state_dict`` as ``<dir>/<key>/flow.pt``,
  ``load_flows_from_folder`` reads them back.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.flows import MAF
from ...utils.model_output import ModelOutput
from ..base.base_sampler import BaseSampler
from .maf_sampler_config import MAFSamplerConfig

logger = logging.getLogger(__name__)


def fit_plan(n: int, num_epochs: int, batch_size: int):
    """(indices, weights), each (steps, batch): per epoch a permutation of
    ``np.random.default_rng(0)`` in batches, the last one padded with
    index 0 and weight 0."""
    bs = min(batch_size, n)
    idx_rng = np.random.default_rng(0)
    idx_rows, w_rows = [], []
    for _ in range(num_epochs):
        perm = idx_rng.permutation(n)
        for b in range(0, n, bs):
            chunk = perm[b:b + bs]
            pad = bs - chunk.shape[0]
            idx_rows.append(np.pad(chunk, (0, pad)))
            w_rows.append(np.pad(np.ones(chunk.shape[0], np.float32), (0, pad)))
    return np.stack(idx_rows), np.stack(w_rows)


class MAFSampler(BaseSampler):
    """Fits one MAF per latent space (shared and per-modality private)."""

    flow_class = MAF
    name = "MAFSampler"

    def __init__(self, model, sampler_config=None):
        if sampler_config is None:
            sampler_config = MAFSamplerConfig()
        super().__init__(model, sampler_config)
        self.flows_dims = dict(shared=model.model_config.latent_dim)
        if model.multiple_latent_spaces:
            self.flows_dims.update(model.style_dims)
        self.flows_models = nn.ModuleDict({
            key: self.flow_class(int(dim), n_made_blocks=sampler_config.n_made_blocks,
                                 hidden_size=sampler_config.hidden_size,
                                 n_hidden_in_made=sampler_config.n_hidden_in_made)
            for key, dim in self.flows_dims.items()}).to(self.device)
        self.last_loss = {}

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None):
        """Standard-normal draws of ``shape`` on the device (a hook)."""
        return torch.randn(shape, generator=generator, device=self.device)

    # ------------------------------------------------------------------ fit
    def _fit_one_flow(self, key: str, data, num_epochs: int, batch_size: int,
                      learning_rate: float):
        flow = self.flows_models[key]
        idx, w = fit_plan(data.shape[0], num_epochs, batch_size)
        idx = torch.tensor(idx, device=data.device)
        w = torch.tensor(w, device=data.device)
        optimizer = torch.optim.Adam(flow.parameters(), lr=learning_rate)
        for ii, ww in zip(idx, w):
            loss = -(flow.log_prob(data[ii]) * ww).sum() / ww.sum()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        self.last_loss[key] = loss.item()
        logger.info("Flow '%s' fitted, final nll=%.4f", key, self.last_loss[key])

    def fit(self, train_data, eval_data=None, num_epochs: int = 10, batch_size: int = 100,
            learning_rate: float = 1e-3, seed: int = 0, **kwargs):
        """Encode the train set, draw the flows' weights from ``seed`` and
        fit one flow per latent space."""
        z, mod_z = self._collect_latents(train_data, batch_size=batch_size, device=True)
        latents = {"shared": z, **(mod_z or {})}
        generator = torch.Generator().manual_seed(seed)
        for flow in self.flows_models.cpu().values():
            flow.reset_parameters(generator)
        self.flows_models.to(self.device)
        for key in self.flows_models:
            self._fit_one_flow(key, latents[key], num_epochs, batch_size, learning_rate)
        self.is_fitted = True

    # --------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(self, n_samples: int = 1, batch_size: int = 500,
               generator: Optional[torch.Generator] = None, **kwargs) -> ModelOutput:
        """u ~ N(0, I) -> each flow's ``inverse``."""
        self._check_fitted()
        z_gen = {key: flow.inverse(self.draw_noise((n_samples, self.flows_dims[key]),
                                                   generator))["out"]
                 for key, flow in self.flows_models.items()}
        output = ModelOutput(z=z_gen.pop("shared"),
                             one_latent_space=not self.model.multiple_latent_spaces)
        if self.model.multiple_latent_spaces:
            output["modalities_z"] = z_gen
        return output

    # ------------------------------------------------------------ save/load
    def save(self, dir_path: str):
        """Save the config and the fitted flows."""
        self._check_fitted()
        super().save(dir_path)
        for key, flow in self.flows_models.items():
            path = os.path.join(dir_path, key)
            os.makedirs(path, exist_ok=True)
            torch.save(flow.state_dict(), os.path.join(path, "flow.pt"))

    def load_flows_from_folder(self, dir_path: str):
        """Load fitted flows saved by ``save`` instead of calling ``fit``."""
        for key, flow in self.flows_models.items():
            path = os.path.join(dir_path, key, "flow.pt")
            try:
                flow.load_state_dict(torch.load(path, map_location=self.device,
                                                weights_only=True))
            except Exception as exc:
                raise AttributeError(
                    "Error when trying to load the flows from the folder. Check that "
                    f"you provided the right path. Exception: {exc}") from exc
        self.is_fitted = True
