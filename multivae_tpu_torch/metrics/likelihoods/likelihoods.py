"""Joint-NLL evaluator (counterpart of
``multivae_tpu/metrics/likelihoods/likelihoods.py``): the dataset in
batches through the model's K-sample joint NLL, summed and divided by the
number of rows."""

from __future__ import annotations

import torch

from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from .likelihoods_config import LikelihoodsEvaluatorConfig


class LikelihoodsEvaluator(Evaluator):
    """Computes the K-sample IWAE estimate of the joint NLL."""

    def __init__(self, model, test_dataset, output=None, eval_config=None, sampler=None,
                 generator=None):
        if eval_config is None:
            eval_config = LikelihoodsEvaluatorConfig()
        super().__init__(model, test_dataset, output, eval_config, sampler, generator)
        self.num_samples = eval_config.num_samples
        self.batch_size_k = eval_config.batch_size_k
        self.unified = eval_config.unified_implementation

    def eval(self):
        self.joint_nll()
        self.log_to_wandb()
        return ModelOutput(**self.metrics)

    @torch.no_grad()
    def joint_nll(self):
        """Sum the per-batch NLLs over the real rows. The scalar estimators
        weigh the rows themselves (0 on the loader's padding); a paper
        estimator that returns one NLL a row (MMVAE's) is masked here."""
        partials = []
        for batch in self.test_loader:
            if self.unified or not hasattr(self.model, "compute_joint_nll_paper"):
                nll = self.model.compute_joint_nll(batch, self.num_samples,
                                                   self.batch_size_k,
                                                   generator=self.generator)
            else:
                self.logger.info("Using the paper version of the joint nll.")
                nll = self.model.compute_joint_nll_paper(batch, self.num_samples,
                                                         self.batch_size_k,
                                                         generator=self.generator)
                if nll.ndim:
                    nll = (nll * (batch.weights > 0).to(nll)).sum()
            partials.append(nll.float())
        joint_nll = float(torch.stack(partials).sum()) / self.n_data
        self.logger.info("Mean Joint likelihood : %s", joint_nll)
        self.metrics["joint_likelihood"] = joint_nll
        return joint_nll

    @torch.no_grad()
    def joint_nll_from_subset(self, subset):
        """The joint NLL with one subset's posterior as the importance
        distribution (MoPoE only; None for other models)."""
        if not hasattr(self.model, "_compute_joint_nll_from_subset_encoding"):
            return None
        ll = 0.0
        for batch in self.test_loader:
            ll += float(self.model._compute_joint_nll_from_subset_encoding(
                subset, batch, self.num_samples, self.batch_size_k,
                generator=self.generator))
        joint_nll = ll / self.n_data
        self.logger.info("Joint likelihood from subset %s", joint_nll)
        self.metrics[f"Joint likelihood from subset {subset}"] = joint_nll
        return joint_nll
