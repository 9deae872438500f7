"""The port's data layer against the JAX package's: the loader's epoch
plan (permutation, wrap-around padding, weights) and the batches it
yields must be identical, so both packages train on the same batches in
the same order."""

import numpy as np
import pytest
import torch

from multivae_tpu.data import IncompleteDataset as JIncomplete
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.loader import DataLoader as JLoader
from multivae_tpu_torch.data import (
    DataLoader,
    IncompleteDataset,
    MultimodalBaseDataset,
    MultimodalBatch,
    as_batch,
    batch_from_arrays,
)

torch.set_num_threads(2)


def _data(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 2, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("n,batch_size,shuffle,drop_last,epoch", [
    (23, 5, True, False, 1),
    (23, 5, True, False, 4),
    (23, 5, True, True, 2),
    (20, 5, True, False, 3),
    (3, 8, True, False, 1),    # pad larger than the dataset: cycles
    (23, 5, False, False, 1),
])
def test_epoch_plan_matches_jax(n, batch_size, shuffle, drop_last, epoch):
    data = _data(n)
    ours = DataLoader(MultimodalBaseDataset(data), batch_size, shuffle=shuffle,
                      seed=7, drop_last=drop_last)
    theirs = JLoader(JDataset(data), batch_size, shuffle=shuffle, seed=7,
                     drop_last=drop_last)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert len(ours) == len(theirs)
    idx, w = ours.epoch_plan()
    jidx, jw = theirs.epoch_plan()
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)


def test_batches_match_jax_with_masks():
    data = _data(11, seed=1)
    rng = np.random.default_rng(2)
    masks = {m: rng.uniform(size=11) > 0.3 for m in data}
    ours = DataLoader(IncompleteDataset(data, masks), 4, seed=3)
    theirs = JLoader(JIncomplete(data, masks), 4, seed=3)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    n_batches = 0
    for tb, jb in zip(ours, theirs):
        n_batches += 1
        assert isinstance(tb, MultimodalBatch) and tb.incomplete == jb.incomplete
        for m in data:
            np.testing.assert_array_equal(tb.data[m].numpy(), np.asarray(jb.data[m]))
            np.testing.assert_array_equal(tb.masks[m].numpy(), np.asarray(jb.masks[m]))
        np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    assert n_batches == 3


def test_batch_from_arrays_defaults_and_to():
    b = batch_from_arrays(_data(6))
    assert not b.incomplete and b.n_samples == 6
    assert all(torch.equal(v, torch.ones(6)) for v in b.masks.values())
    assert torch.equal(b.weights, torch.ones(6))
    moved = b.to("cpu")
    assert moved.data["b"].shape == (6, 2, 2, 2)


def test_as_batch_accepts_datasets_and_dicts():
    data = _data(6)
    masks = {m: np.arange(6) % 2 == 0 for m in data}
    from_ds = as_batch(IncompleteDataset(data, masks)[:4])
    assert from_ds.incomplete and from_ds.n_samples == 4
    np.testing.assert_array_equal(from_ds.masks["a"].numpy(), [1, 0, 1, 0])
    assert not as_batch(data).incomplete
    assert as_batch(from_ds) is from_ds


def test_dataset_length_checks():
    data = _data(6)
    data["a"] = data["a"][:5]
    with pytest.raises(AttributeError):
        MultimodalBaseDataset(data)
    with pytest.raises(AttributeError):
        IncompleteDataset(_data(6), {"a": np.ones(6, bool)})
