"""k-means in PyTorch, on the device of its data (the latent clustering
evaluator's; the JAX package calls scikit-learn's ``KMeans`` on the host).

It keeps scikit-learn's ``KMeans`` rules (``algorithm="lloyd"``):

- the data are centred on their mean for the fit, and the mean is added
  back to the returned centres;
- greedy k-means++ seeding with ``2 + int(log(k))`` candidates a centre
  (drawn from an explicit ``torch.Generator``: its draws differ from
  scikit-learn's RNG), or given initial centres; one initialisation
  (``n_init="auto"`` with k-means++);
- Lloyd iterations, at most ``MAX_ITER``: assign each row to the centre of
  least ``|c|^2 - 2 x.c`` (the first on a tie), average each cluster, give
  an empty cluster the row farthest from its old centre; stop when the
  labels repeat, or when the squared centre shifts sum to at most ``TOL``
  times the mean per-feature variance of the data;
- unless the labels repeated, a final assignment to the returned centres.

``predict`` measures distances from the fit's mean too (scikit-learn's
measures them on the raw data): latents far from the origin next to their
spread, as a briefly trained model's are, would otherwise lose the
distance margins to float32 rounding of |x|^2-sized terms.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# scikit-learn's KMeans defaults
MAX_ITER = 300
TOL = 1e-4


def _assign(X, centers):
    """Index of each row's nearest centre and the squared-distance table
    without the rows' own norms, (n, k)."""
    partial = (centers * centers).sum(1)[None] - 2.0 * (X @ centers.T)
    return partial.argmin(1), partial


def _sq_dist(A, X):
    """(len(A), len(X)) squared distances, clipped at 0."""
    d = (A * A).sum(1)[:, None] - 2.0 * (A @ X.T) + (X * X).sum(1)[None]
    return d.clamp_min(0.0)


def kmeans_plusplus(X, n_clusters: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy k-means++ seeding: the first centre uniformly among the rows,
    each next one the best (least summed squared distance) of ``2 +
    int(log(k))`` rows drawn with probability proportional to their squared
    distance to the nearest centre so far."""
    n = X.shape[0]
    draw_device = generator.device if generator is not None else X.device
    n_trials = 2 + int(math.log(n_clusters))
    first = int(torch.randint(n, (), generator=generator, device=draw_device))
    centers = [X[first]]
    closest = _sq_dist(X[first][None], X)[0]
    potential = closest.sum()
    for _ in range(1, n_clusters):
        u = torch.rand(n_trials, generator=generator, device=draw_device).to(X)
        candidates = torch.searchsorted(torch.cumsum(closest, 0), u * potential)
        candidates = candidates.clamp_max(n - 1)
        dist = torch.minimum(closest[None], _sq_dist(X[candidates], X))
        pots = dist.sum(1)
        best = int(pots.argmin())
        closest, potential = dist[best], pots[best]
        centers.append(X[candidates[best]])
    return torch.stack(centers)


def _lloyd(X, centers, max_iter: int, tol: float):
    k = centers.shape[0]
    labels_old = None
    strict = False
    for it in range(max_iter):
        labels, _ = _assign(X, centers)
        sums = torch.zeros_like(centers).index_add_(0, labels, X)
        counts = torch.bincount(labels, minlength=k).to(X.dtype)
        empty = torch.nonzero(counts == 0).flatten()
        if len(empty):
            far_dist = ((X - centers[labels]) ** 2).sum(1)
            if float(far_dist.max()) > 0:
                far = torch.topk(far_dist, len(empty)).indices
                for new, row in zip(empty.tolist(), far.tolist()):
                    old = int(labels[row])
                    sums[old] -= X[row]
                    counts[old] -= 1
                    sums[new] = X[row]
                    counts[new] = 1
        new_centers = torch.where(counts[:, None] > 0,
                                  sums / counts.clamp_min(1)[:, None], sums)
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if float(shift) <= tol:
            break
        labels_old = labels
    if not strict:
        labels, _ = _assign(X, centers)
    inertia = ((X - centers[labels]) ** 2).sum()
    return labels, inertia, centers, it + 1


class KMeans:
    """k-means on the device of the data it is given (see the module's
    docstring for the rules).

    Args:
        n_clusters: number of clusters.
        init: ``"k-means++"`` or an (n_clusters, D) array of initial centres.
        generator: the k-means++ draws' generator (its device's RNG when
            None).
    """

    def __init__(self, n_clusters: int = 8, init="k-means++",
                 generator: Optional[torch.Generator] = None):
        self.n_clusters = n_clusters
        self.init = init
        self.generator = generator

    def fit(self, X) -> "KMeans":
        X = torch.as_tensor(X)
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        tol = float(X.var(0, unbiased=False).mean()) * TOL
        mean = X.mean(0)
        Xc = X - mean
        if isinstance(self.init, str):
            if self.init != "k-means++":
                raise ValueError(f"init must be 'k-means++' or an array, got {self.init!r}")
            centers = kmeans_plusplus(Xc, self.n_clusters, self.generator)
        else:
            centers = torch.as_tensor(self.init).to(X) - mean
        labels, inertia, centers, n_iter = _lloyd(Xc, centers, MAX_ITER, tol)
        self.mean_ = mean
        self.cluster_centers_ = centers + mean
        self.labels_ = labels
        self.inertia_ = float(inertia)
        self.n_iter_ = n_iter
        return self

    def fit_predict(self, X) -> torch.Tensor:
        return self.fit(X).labels_

    def predict(self, X) -> torch.Tensor:
        """Index of the nearest fitted centre of each row."""
        X = torch.as_tensor(X).to(self.cluster_centers_)
        return _assign(X - self.mean_, self.cluster_centers_ - self.mean_)[0]
