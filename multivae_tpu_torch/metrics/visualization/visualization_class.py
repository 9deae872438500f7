"""Visualization module: unconditional and conditional sample grids
(counterpart of
``multivae_tpu/metrics/visualization/visualization_class.py``).

A grid comes back as an (H, W, 3) uint8 array, the pixels of the JAX
package's PIL image, and is written as a PNG by ``data/utils.write_png``;
no image package is needed.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from ...data.batch import batch_from_arrays
from ...data.utils import adapt_shape, grid_to_image, make_grid, write_png
from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from .visualize_config import VisualizationConfig


class Visualization(Evaluator):
    """Grid visualizations of model generations."""

    def __init__(self, model, test_dataset, output=None, eval_config=None, sampler=None,
                 generator=None):
        if eval_config is None:
            eval_config = VisualizationConfig()
        super().__init__(model, test_dataset, output, eval_config, sampler, generator)
        self.n_samples = eval_config.n_samples
        self.n_data_cond = eval_config.n_data_cond

    def _plottable(self, x, mod):
        return self.test_dataset.transform_for_plotting(x.detach().cpu().numpy(), mod)

    def _to_image(self, recon: dict, nrow: int) -> np.ndarray:
        recon, _ = adapt_shape(recon)
        return grid_to_image(make_grid(np.concatenate(list(recon.values()), axis=0),
                                       nrow=nrow))

    def _save(self, image, file_name: str, wandb_key: str):
        if self.output is not None:
            write_png(os.path.join(self.output, f"{file_name}.png"), image)
        if self.wandb_run is not None:
            import wandb

            self.wandb_run.log({wandb_key: wandb.Image(image)})

    @torch.no_grad()
    def unconditional_samples(self, **kwargs) -> np.ndarray:
        """A row of ``n_samples`` joint generations per modality (from the
        prior or the sampler)."""
        if self.sampler is None:
            samples = self.model.generate_from_prior(self.n_samples, generator=self.generator)
        else:
            samples = self.sampler.sample(self.n_samples)
        recon = self.model.decode(samples)
        image = self._to_image({m: self._plottable(recon[m], m) for m in recon},
                               self.n_samples)
        self._save(image, "unconditional", "unconditional_generation")
        return image

    @torch.no_grad()
    def conditional_samples_subset(self, subset: list,
                                   gen_mod: Union[list, str] = "all") -> np.ndarray:
        """``n_data_cond`` test rows (``default_rng(0)``'s permutation) and
        ``n_samples`` generations of ``gen_mod`` from ``subset`` each."""
        idx = np.random.default_rng(0).permutation(len(self.test_dataset))[: self.n_data_cond]
        batch = batch_from_arrays(data=self.test_dataset.get_batch(idx)["data"])
        recon = self.model.predict(batch, cond_mod=subset, gen_mod=gen_mod,
                                   N=self.n_samples, flatten=True,
                                   generator=self.generator, ignore_incomplete=True)
        out = {f"original_{m}": self._plottable(batch.data[m], m) for m in subset}
        out.update({m: self._plottable(recon[m], m) for m in recon})
        image = self._to_image(out, self.n_data_cond)
        name = f"conditional_from_subset_{subset}"
        self._save(image, name, name)
        return image

    def reconstruction(self, modality: str, **kwargs) -> np.ndarray:
        return self.conditional_samples_subset([modality], gen_mod=modality)

    def eval(self):
        image = self.unconditional_samples()
        return ModelOutput(unconditional_generation=image)
