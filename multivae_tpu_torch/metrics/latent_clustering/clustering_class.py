"""Latent clustering evaluator: k-means on the joint embeddings of a train
set, each cluster labelled by its majority class, accuracy on the test set
(counterpart of
``multivae_tpu/metrics/latent_clustering/clustering_class.py``). The
k-means is the port's own (``ops/kmeans.py``), on the model's device, with
its k-means++ draws from the evaluator's generator. Over a process group
each process encodes its columns of each batch and the latents (and
labels) are gathered in the global batch's order, so that every process
fits the same k-means from a generator in the same state; the test
accuracy's counts are added over the group. A fit batch that does not
divide over the processes is encoded whole by each."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ...data.loader import DataLoader
from ...ops.kmeans import KMeans
from ...utils.model_output import ModelOutput
from ..base.evaluator_class import Evaluator
from .clustering_config import ClusteringConfig


class Clustering(Evaluator):
    """k-means on joint embeddings, majority-label cluster accuracy."""

    def __init__(self, model, test_dataset, train_dataset, output=None, eval_config=None,
                 generator=None):
        if eval_config is None:
            eval_config = ClusteringConfig()
        super().__init__(model, test_dataset, output, eval_config, generator=generator)
        self.num_samples_for_fit = eval_config.num_samples_for_fit
        self.n_fits = eval_config.number_of_runs
        self.use_mean = eval_config.use_mean
        self.clustering = KMeans(n_clusters=eval_config.n_clusters, generator=generator)
        self.train_dataset = train_dataset

    def _embed(self, batch, mods, sharded=True):
        """The latents of ``batch``'s real rows: this process's columns of
        a global batch, or (``sharded`` False) a whole batch alike on every
        process."""
        with self.on_ranks() if sharded else contextlib.nullcontext():
            z = self.model.encode(batch, mods, return_mean=self.use_mean,
                                  generator=self.generator, ignore_incomplete=True).z
        return z[(batch.weights > 0).to(z.device)]

    @torch.no_grad()
    def fit_clustering(self, mods="all"):
        """Fit the k-means on the train set's embeddings (the first
        ``num_samples_for_fit`` rows or more, in the loader's shuffled
        order) and label each cluster with its majority class."""
        batch_size = min(self.batch_size, len(self.train_dataset))
        world = self.mesh.world_size
        sharded = self.shard.distributed and batch_size % world == 0
        dl = DataLoader(self.train_dataset, batch_size, shuffle=True,
                        num_processes=world if sharded else 1,
                        process_index=self.mesh.rank if sharded else 0)
        list_z, labels = [], []
        n_samples = 0
        for batch in dl:
            if self.num_samples_for_fit is not None and n_samples > self.num_samples_for_fit:
                break
            valid = batch.weights > 0
            z = self._embed(batch, mods, sharded)
            list_z.append(self.gather_valid(z, valid) if sharded else z)
            if batch.labels is not None:
                own = batch.labels[valid]
                labels.append(self.gather_valid(own, valid) if sharded else own)
            n_samples += len(list_z[-1])

        cluster_labels = self.clustering.fit_predict(torch.cat(list_z)).cpu()
        k = self.clustering.n_clusters
        # a cluster is its own label unless the train labels say otherwise
        self.cluster_to_label = torch.arange(k)
        if labels:
            labels = torch.cat(labels).long()
            if len(labels) == len(cluster_labels):
                for c in torch.unique(cluster_labels).tolist():
                    self.cluster_to_label[c] = torch.bincount(
                        labels[cluster_labels == c]).argmax()

    @torch.no_grad()
    def cluster_accuracy(self, mods="all"):
        """The test accuracy of the clusters' labels, averaged over
        ``number_of_runs`` fits."""
        mean_acc = []
        for _ in range(self.n_fits):
            self.fit_clustering(mods)
            acc, n_samples = 0, 0
            for batch in self.test_loader:
                clusters = self.clustering.predict(self._embed(batch, mods)).cpu()
                pred = self.cluster_to_label[clusters]
                acc += int((pred == batch.labels[batch.weights > 0]).sum())
                n_samples += len(pred)
            acc, n_samples = self.sum_over_ranks([acc, n_samples])
            mean_acc.append(acc / n_samples)
        accuracy = float(np.mean(mean_acc))
        self.metrics["cluster_accuracy"] = accuracy
        self.logger.info("Cluster accuracy is %s", accuracy)
        return ModelOutput(cluster_accuracy=accuracy)

    def eval(self):
        output = self.cluster_accuracy("all")
        self.log_to_wandb()
        return output
