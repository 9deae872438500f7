"""CMVAE: MMVAE+'s shared and private codes with a clustering prior on the
shared code.

Counterpart of ``multivae_tpu/models/cmvae/cmvae_model.py``:

- the prior of u is a mixture of ``number_of_clusters`` components with
  learnable means ``mean_clusters`` (drawn from U(-1, 1)), unit scales and
  mixture weights ``softmax(pc_params)``; the private codes keep a fixed
  unit prior;
- the log importance weights take the expectation over q(c|z) explicitly,
  on the (C, M, K, B) layout, beside the terms MMVAE+ shares with it
  (``MMVAEPlus._k_lw_terms``: the one mixture-of-experts call, the private
  posterior, the masked reconstructions); both objectives and the joint
  NLL are MMVAE+'s;
- ``encode`` samples the shared code from one random conditioning modality
  (its mean with ``return_mean``), ``generate_from_prior`` draws a cluster
  per sample, ``predict_clusters`` assigns clusters by a majority vote over
  the modalities (ties to the lowest cluster), and ``prune_clusters``
  removes clusters one by one on the host, writing -inf into
  ``pc_params`` and keeping the count of least entropy.

A pruned cluster (``pc_params = -inf``) makes ``log softmax`` -inf, and the
objective's ``1e-20 * -inf`` terms make the loss nan or inf; the JAX
package gives the same, and the port follows it. The clusters of
``generate_from_prior`` are drawn through ``draw_clusters``, so a test can
feed another package's draws.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

from ...data.batch import MultimodalBatch, as_batch
from ...ops.gaussian import sum_f32
from ...ops.kdist import dist_log_prob, dist_rsample, log_var_to_std
from ...utils.model_output import ModelOutput
from ..base.base_ae_model import pick_expert
from ..mmvaePlus.mmvaePlus_model import MMVAEPlus
from .cmvae_config import CMVAEConfig

logger = logging.getLogger(__name__)


class CMVAE(MMVAEPlus):
    """CMVAE model (clustering prior on the shared latent space)."""

    model_name = "CMVAE"

    def __init__(self, model_config: CMVAEConfig, encoders: dict = None,
                 decoders: dict = None, seed: int = 0, device="cuda"):
        self.n_clusters = model_config.number_of_clusters
        super().__init__(model_config, encoders, decoders, seed=seed, device=device)

    def _init_extra_params(self):
        """The modality priors' log-variances (learnable per the config),
        the mixture logits ``pc_params`` (zeros) and the cluster means
        ``mean_clusters`` (U(-1, 1), from the model's seed)."""
        extra = {}
        if self.model_config.learn_modality_prior:
            for m in self.encoders:
                extra[f"prior_log_var_{m}"] = nn.Parameter(
                    torch.zeros(1, self.modalities_specific_dim))
        extra["pc_params"] = nn.Parameter(torch.zeros(self.n_clusters))
        generator = torch.Generator().manual_seed(self._seed)
        extra["mean_clusters"] = nn.Parameter(
            2.0 * torch.rand(self.n_clusters, self.latent_dim, generator=generator) - 1.0)
        return extra

    def _cluster_stds(self):
        """The clusters' fixed unit scales, (C, D) at the original count:
        pruning changes the weights, never the parameters' shapes."""
        log_var = torch.zeros_like(self.mean_clusters.detach())
        return log_var_to_std(log_var, self.dist_name)

    def _w_prior(self):
        """(mean, std) of the private codes' fixed prior, (1, S), in
        ``param_dtype``."""
        mean = torch.zeros(1, self.modalities_specific_dim, device=self.device,
                           dtype=self.param_dtype)
        return mean, log_var_to_std(mean, self.dist_name)

    def draw_clusters(self, logits, n_samples: int,
                      generator: Optional[torch.Generator] = None):
        """``n_samples`` cluster indices drawn from ``softmax(logits)``."""
        return torch.multinomial(torch.softmax(logits, -1), n_samples,
                                 replacement=True, generator=generator)

    # ------------------------------------------------------------ objective
    def _compute_k_lws(self, batch: MultimodalBatch, posteriors, zs, recons,
                       detach_posteriors: bool, beta: Optional[float] = None,
                       unit_rescale: bool = False):
        """MMVAE+'s weights with the prior of u replaced by the cluster
        mixture, its expectation over q(c|z) taken over (C, M, K, B)."""
        beta = self.beta if beta is None else beta
        t = self._k_lw_terms(batch, posteriors, zs, recons, detach_posteriors,
                             unit_rescale)
        w_mu, w_std = self._w_prior()
        lpw = sum_f32(dist_log_prob(self.dist_name, t["W"], w_mu, w_std))  # (M, K, B)
        lpc = torch.log(torch.softmax(self.pc_params, -1))[:, None, None, None]
        lpzc = sum_f32(dist_log_prob(self.dist_name, t["U"][None],
                                     self.mean_clusters[:, None, None, None, :],
                                     self._cluster_stds()[:, None, None, None, :]))
        qzc = torch.softmax(lpc + lpzc, 0) + 1e-20                        # (C, M, K, B)
        lw_c = t["lpx_z"][None] + beta * (lpc + lpzc + lpw[None] - t["lqu_x"][None]
                                          - t["lqw_x"][None] - torch.log(qzc))
        lw = (qzc * lw_c).sum(0) * t["mask"][:, None, :]
        return {m: lw[i] for i, m in enumerate(posteriors)}, t["n_mods_sample"]

    # ------------------------------------------------------------ inference
    def _shared_posterior(self, posteriors, cond_mod: tuple, return_mean: bool,
                          generator: Optional[torch.Generator]):
        """One random conditioning modality's posterior, whose mean
        ``return_mean`` takes."""
        idx = self.draw_expert(len(cond_mod), generator)
        return tuple(pick_expert(torch.stack([posteriors[m]["u"][i] for m in cond_mod]), idx)
                     for i in range(2))

    def _style_prior(self, mod: str):
        if self.reconstruction_option == "single_prior":
            return self._modality_prior(mod)
        return self._w_prior()

    def generate_from_prior(self, n_samples: int,
                            generator: Optional[torch.Generator] = None) -> ModelOutput:
        """A cluster per sample, the shared code from its component and the
        private codes from their priors: z (n_samples, D) and
        ``modalities_z`` (n_samples, S) per modality."""
        clusters = self.draw_clusters(self.pc_params.detach(), n_samples, generator)
        means = self.mean_clusters[clusters]
        z = dist_rsample(self.dist_name, means, self._cluster_stds()[clusters],
                         u=self.draw_noise(means.shape, generator))
        style_z = {}
        for m in self.encoders:
            mu, std = (t.expand(n_samples, -1) for t in self._style_prior(m))
            style_z[m] = dist_rsample(self.dist_name, mu, std,
                                      u=self.draw_noise(mu.shape, generator))
        return ModelOutput(z=z, one_latent_space=False, modalities_z=style_z)

    @torch.no_grad()
    def predict_clusters(self, inputs, compute_lliks: bool = False,
                         generator: Optional[torch.Generator] = None) -> ModelOutput:
        """Per modality, a sample of u and its cluster posterior ``pc_zs``
        (C, B); ``clusters`` (B,) is the majority vote over the modalities,
        ties going to the lowest cluster. ``compute_lliks`` adds
        ``norm_lliks`` (B,), the expected log joint of u and c per latent
        dimension, averaged over the modalities."""
        batch = as_batch(inputs).to(self.device)
        lpc = torch.log(torch.softmax(self.pc_params, -1) + 1e-20)[:, None]
        means, stds = self.mean_clusters[:, None], self._cluster_stds()[:, None]
        assigns, pc_zs, norm_lliks = [], {}, []
        for mod in batch.data:
            o = self.encode_mod(mod, batch.data[mod])
            mu = o["embedding"]
            z = dist_rsample(self.dist_name, mu,
                             log_var_to_std(o["log_covariance"], self.dist_name),
                             u=self.data_shard.draw(self.draw_noise, mu.shape, generator))
            lpz_c = dist_log_prob(self.dist_name, z[None], means, stds).sum(-1)  # (C, B)
            pc_z = torch.softmax(lpc + lpz_c, 0)
            assigns.append(pc_z.argmax(0))
            pc_zs[mod] = pc_z
            if compute_lliks:
                norm_lliks.append(((lpz_c + lpc - torch.log(pc_z + 1e-20)) * pc_z).sum(0)
                                  / self.latent_dim)
        votes = nn.functional.one_hot(torch.stack(assigns, -1),
                                      self.model_config.number_of_clusters).sum(1)
        out = ModelOutput(clusters=votes.argmax(-1), pc_zs=pc_zs)
        if compute_lliks:
            out["norm_lliks"] = torch.stack(norm_lliks).mean(0)
        return out

    def prune_clusters(self, train_data, batch_size: int = 128,
                       generator: Optional[torch.Generator] = None) -> list:
        """Remove clusters one at a time, the one of least mass first, down
        to 2; keep the count whose clustering entropy (``beta`` times the
        normalized entropy of q(c|z) minus ``norm_lliks``, averaged over
        the train rows) is least. Writes -inf into ``pc_params`` for the
        removed clusters, sets ``n_clusters`` and returns the entropy per
        cluster count (inf where not computed)."""
        from ...data.loader import DataLoader

        max_clusters = self.model_config.number_of_clusters
        h_values = [np.inf] * (max_clusters + 1)
        n_cluster_params = [None] * (max_clusters + 1)
        while self.n_clusters >= 2:
            loader = DataLoader(train_data, batch_size=batch_size, shuffle=False,
                                drop_last=False)
            mass = np.zeros(max_clusters)
            h_data = []
            for batch in loader:
                pred = self.predict_clusters(batch, compute_lliks=True,
                                             generator=generator)
                valid = batch.weights.numpy() > 0
                mass += np.bincount(pred.clusters.cpu().numpy()[valid],
                                    minlength=max_clusters)
                h_pzc = []
                for pc_z in pred.pc_zs.values():
                    p = pc_z.cpu().numpy()[:, valid]          # (C, B)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        ent = -(p * np.log(p, where=p > 0, out=np.zeros_like(p))).sum(0)
                        h_pzc.append(ent / np.log(np.count_nonzero(p > 1e-12, axis=0)))
                h_data.append(self.model_config.beta * np.stack(h_pzc).mean(0)
                              - pred.norm_lliks.cpu().numpy()[valid])
            h_values[self.n_clusters] = float(np.concatenate(h_data).mean())
            logger.info("Entropy with %d clusters: %s", self.n_clusters,
                        h_values[self.n_clusters])
            pc = self.pc_params.detach().cpu().numpy().copy()
            n_cluster_params[self.n_clusters] = pc.copy()

            # remove the cluster of least mass
            self.n_clusters -= 1
            mass[np.isinf(pc)] = np.inf
            pc[int(np.argmin(mass))] = -np.inf
            with torch.no_grad():
                self.pc_params.copy_(torch.from_numpy(pc))
        self.n_clusters = int(np.argmin(np.asarray(h_values)))
        with torch.no_grad():
            self.pc_params.copy_(torch.from_numpy(n_cluster_params[self.n_clusters]))
        logger.info("The optimal number of clusters is %d", self.n_clusters)
        return h_values
