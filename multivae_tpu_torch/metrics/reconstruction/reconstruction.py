"""Reconstruction evaluator: SSIM or MSE of the modalities of a subset
generated from that subset (counterpart of
``multivae_tpu/metrics/reconstruction/reconstruction.py``), for the joint
subset and each modality alone, one subset at a time."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...ops.ssim import ssim
from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from .reconstruction_config import ReconstructionConfig


class Reconstruction(Evaluator):
    """Reconstruction metrics per conditioning subset."""

    def __init__(self, model, test_dataset, output=None, eval_config=None, generator=None):
        if eval_config is None:
            eval_config = ReconstructionConfig()
        super().__init__(model, test_dataset, output, eval_config, generator=generator)
        self.metric_name = eval_config.metric

    @torch.no_grad()
    def reconstruction_from_subset(self, subset: List[str]):
        """SSIM: the mean over batches and modalities of the batch's SSIM,
        weighted by its real rows. MSE: the summed squared error over the
        rows and modalities, divided by the count of (row, modality)
        pairs."""
        vals, weights = [], []
        total, n_data = 0.0, 0
        for batch in self.test_loader:
            valid = batch.weights > 0
            output = self.model.predict(batch, list(subset), list(subset),
                                        generator=self.generator, ignore_incomplete=True)
            for mod in subset:
                preds = output[mod][valid.to(output[mod].device)]
                target = batch.data[mod][valid].to(preds)
                if self.metric_name == "SSIM":
                    vals.append(float(ssim(preds, target)))
                    weights.append(int(valid.sum()))
                else:
                    total += float(((preds - target) ** 2).sum())
                    n_data += preds.shape[0]
        if self.metric_name == "SSIM":
            mean_recon_error = float(np.average(vals, weights=weights))
        else:
            mean_recon_error = total / n_data
        self.logger.info("Subset %s reconstruction : %s", subset, mean_recon_error)
        self.metrics[f"{subset} reconstruction error ({self.metric_name})"] = mean_recon_error
        return mean_recon_error

    def eval(self):
        """The joint subset's metric, then each modality's alone."""
        self.reconstruction_from_subset(list(self.model.encoders.keys()))
        for mod in self.model.encoders.keys():
            self.reconstruction_from_subset([mod])
        self.log_to_wandb()
        return ModelOutput(**self.metrics)
