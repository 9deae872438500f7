"""Microbatched gradient accumulation (counterpart of
``multivae_tpu/ops/microbatch.py``).

The K-sample objectives (MMVAE, MMVAE+, CMVAE) are sums over the batch's
rows, so the gradient of a batch is the sum of the gradients of its
chunks. Running ``loss`` and ``backward`` chunk after chunk keeps one
chunk's activations alive at a time: the peak falls with the chunk count
and nothing is recomputed, where ``use_remat`` pays a second forward.

Not exact for losses with a normalizer that depends on the whole batch
(MVAE's count of effective rows); the trainer refuses models that do not
declare ``loss_is_sum = True``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

from ..data.batch import MultimodalBatch, map_leaves
from ..utils.model_output import ModelOutput


def split_batch(batch: MultimodalBatch, n_micro: int) -> List[MultimodalBatch]:
    """``n_micro`` batches of consecutive rows, of B / n_micro rows each."""
    b = batch.n_samples
    if b % n_micro:
        raise ValueError(f"batch axis {b} not divisible by n_micro={n_micro}")
    size = b // n_micro

    def rows(t, i):
        return None if t is None else t[i * size:(i + 1) * size]

    return [MultimodalBatch(data={k: map_leaves(lambda t: rows(t, i), v)
                                  for k, v in batch.data.items()},
                            masks={k: rows(v, i) for k, v in batch.masks.items()},
                            weights=rows(batch.weights, i),
                            labels=rows(batch.labels, i),
                            incomplete=batch.incomplete)
            for i in range(n_micro)]


def microbatched_backward(loss_fn: Callable, batch: MultimodalBatch,
                          n_micro: int, context=contextlib.nullcontext) -> ModelOutput:
    """Run ``loss_fn(chunk)`` and its ``backward`` on each of ``n_micro``
    chunks in turn, each pair inside a fresh ``context()`` (the trainer's
    ``mixed_precision``: bf16 copies of the parameters, cast anew for each
    chunk), so the parameters' ``.grad`` accumulate the sum of the chunks'
    gradients (float32 parameters: a float32 sum). Returns
    ModelOutput(loss, loss_sum, metrics): ``loss`` and ``loss_sum`` summed
    over the chunks and detached, each metric their mean (the chunks are of
    equal size). Each chunk draws its noise when its ``loss_fn`` runs, in
    chunk order."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    loss = loss_sum = 0.0
    metrics = {}
    for chunk in split_batch(batch, n_micro):
        with context():
            out = loss_fn(chunk)
            out["loss"].backward()
        loss = loss + out["loss"].detach()
        loss_sum = loss_sum + out["loss_sum"].detach()
        for k, v in out.get("metrics", {}).items():
            v = v.detach() / n_micro
            metrics[k] = metrics[k] + v if k in metrics else v
    return ModelOutput(loss=loss, loss_sum=loss_sum, metrics=metrics)
