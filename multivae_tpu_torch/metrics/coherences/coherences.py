"""Coherence evaluator: cross-modal and joint generation coherence
(counterpart of ``multivae_tpu/metrics/coherences/coherences.py``).

Classifiers are callables from a generated modality batch, a tensor on the
model's device, to class logits (e.g. ``ClassifierPolyMNIST`` modules).
Accuracy is the per-class recall averaged over the classes, a class with
no rows counting 0. The subsets are swept one at a time, each over the
test loader, in ``all_subsets`` order (the JAX package's
``fused_sweep=False`` path). Over a process group each process classifies
the generations of its columns and the per-class counts are added over
the group; the joint coherence, whose draws follow no batch, is computed
alike by every process.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from ..base.subset_sweep import all_subsets
from .coherences_config import CoherenceEvaluatorConfig


class _PerClassAccuracy:
    """Running per-class accuracy (recall per true class)."""

    def __init__(self, num_classes: int):
        self.correct = np.zeros(num_classes)
        self.total = np.zeros(num_classes)
        self.num_classes = num_classes

    def update_preds(self, preds, labels):
        preds = np.asarray(preds).ravel()
        labels = np.asarray(labels).astype(int).ravel()
        for c in range(self.num_classes):
            sel = labels == c
            self.total[c] += sel.sum()
            self.correct[c] += (preds[sel] == c).sum()

    def sum_over(self, evaluator):
        """The counts summed over ``evaluator``'s process group."""
        sums = evaluator.sum_over_ranks(list(self.correct) + list(self.total))
        self.correct = np.asarray(sums[:self.num_classes])
        self.total = np.asarray(sums[self.num_classes:])

    def compute(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.total > 0, self.correct / self.total, 0.0)


class CoherenceEvaluator(Evaluator):
    """Cross and joint coherence via pretrained classifiers."""

    def __init__(self, model, classifiers: Dict, test_dataset, output: Optional[str] = None,
                 eval_config=None, sampler=None, generator=None):
        if eval_config is None:
            eval_config = CoherenceEvaluatorConfig()
        super().__init__(model, test_dataset, output, eval_config, sampler, generator)
        self.clfs = classifiers
        self.include_recon = eval_config.include_recon
        self.nb_samples_for_joint = eval_config.nb_samples_for_joint
        self.nb_samples_for_cross = eval_config.nb_samples_for_cross
        self.num_classes = eval_config.num_classes
        self.give_details_per_classes = eval_config.give_details_per_class
        if self.num_classes is None:
            raise AttributeError("Please provide the number of classes")

    def _predicted_classes(self, mod, x) -> np.ndarray:
        return self.clfs[mod](x).argmax(-1).cpu().numpy()

    def cross_coherences(self):
        """The coherence from every proper subset to each other modality
        (and to its own with ``include_recon``), averaged by subset size."""
        accs, accs_per_class = {}, {}
        for s in all_subsets(self.model.encoders, 1, self.model.n_modalities - 1):
            subset_dict, mean_acc, mean_acc_per_class = self.coherence_from_subset(
                list(s), return_accuracies_per_labels=True)
            self.metrics.update(subset_dict)
            accs.setdefault(len(s), []).append(mean_acc)
            accs_per_class.setdefault(len(s), []).append(mean_acc_per_class)

        mean_accs = [float(np.mean(a)) for a in accs.values()]
        std_accs = [float(np.std(a)) for a in accs.values()]
        mean_accs_per_class = [np.mean(np.stack(a), axis=0) for a in accs_per_class.values()]
        for i, (m, s) in enumerate(zip(mean_accs, std_accs)):
            self.logger.info("Conditional accuracies for %s modalities : %s +- %s",
                             i + 1, m, s)
            self.metrics[f"mean_coherence_{i + 1}"] = m
            self.metrics[f"std_coherence_{i + 1}"] = s
            if self.give_details_per_classes:
                for c in range(self.num_classes):
                    self.metrics[f"mean_coherence_{i + 1}_class_{c}"] = float(
                        mean_accs_per_class[i][c])
        return mean_accs, std_accs

    @torch.no_grad()
    def coherence_from_subset(self, subset: List[str],
                              return_accuracies_per_labels: bool = False):
        """Accuracy of the classifiers on the modalities generated from
        ``subset``, over the test set (``nb_samples_for_cross`` draws a
        row)."""
        pred_mods = [m for m in self.model.encoders
                     if (m not in subset) or self.include_recon]
        subset_name = "_".join(subset)
        trackers = {m: _PerClassAccuracy(self.num_classes) for m in pred_mods}

        with self.on_ranks():
            for batch in self.test_loader:
                if batch.labels is None:
                    raise AttributeError("Cross-modal coherence cannot be computed on a "
                                         "dataset without labels")
                output = self.model.predict(batch, list(subset), pred_mods,
                                            N=self.nb_samples_for_cross, flatten=True,
                                            generator=self.generator, ignore_incomplete=True)
                # the flattened draws are (N, B): labels and mask tiled N times
                valid = np.tile((batch.weights > 0).numpy(), self.nb_samples_for_cross)
                labels = np.tile(batch.labels.numpy(), self.nb_samples_for_cross)
                for m in pred_mods:
                    preds = self._predicted_classes(m, output[m])
                    trackers[m].update_preds(preds[valid], labels[valid])
        for tracker in trackers.values():
            tracker.sum_over(self)

        acc_per_class = {f"{subset_name}_to_{m}": trackers[m].compute() for m in trackers}
        acc = {k: float(v.mean()) for k, v in acc_per_class.items()}
        self.logger.info("Subset %s accuracies %s", subset, acc)
        mean_pair_acc = float(np.mean(list(acc.values())))
        mean_acc_per_class = np.mean(np.stack(list(acc_per_class.values())), axis=0)
        if return_accuracies_per_labels:
            return acc, mean_pair_acc, mean_acc_per_class
        return acc, mean_pair_acc

    @torch.no_grad()
    def joint_coherence(self):
        """Share of joint generations (from the prior or the sampler, in
        chunks of ``batch_size``) whose modalities the classifiers all give
        the same class."""
        all_same = []
        samples_to_generate = self.nb_samples_for_joint
        while samples_to_generate > 0:
            n = min(self.batch_size, samples_to_generate)
            if self.sampler is None:
                latents = self.model.generate_from_prior(n, generator=self.generator)
            else:
                latents = self.sampler.sample(n)
            if latents["z"].ndim == 1:
                # a single draw comes as (latent,): give it its batch axis
                latents = ModelOutput(latents, z=latents["z"][None])
                if not latents.get("one_latent_space", True):
                    latents["modalities_z"] = {m: v[None] for m, v in
                                               latents["modalities_z"].items()}
            decoded = self.model.decode(latents)
            labels = [self._predicted_classes(m, decoded[m]) for m in decoded]
            all_same.append(np.all(np.stack([lab == labels[0] for lab in labels]),
                                   axis=0).astype(np.float32))
            samples_to_generate -= n
        joint_coherence = float(np.concatenate(all_same).mean())
        sampler_name = "prior" if self.sampler is None else self.sampler.name
        self.logger.info("Joint coherence with sampler %s: %s", sampler_name,
                         joint_coherence)
        self.metrics[f"joint_coherence_{sampler_name}"] = joint_coherence
        return joint_coherence

    def eval(self):
        self.cross_coherences()
        self.joint_coherence()
        self.log_to_wandb()
        return ModelOutput(**self.metrics)
