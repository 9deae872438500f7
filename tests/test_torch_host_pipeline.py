"""The port's host data path on the CPU: the threaded native row gather
(``data/native_gather.py``, ``csrc/gather.cpp``) against numpy and the JAX
package's gather, its routing of the cases the C routine cannot take, a
failed build, and ``PrefetchLoader`` against the plain loader, with the JAX
module's shutdown rules (``tests/test_perf_features.py:90-134``). Every
comparison is exact: the gather copies bytes."""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from multivae_tpu.data.native_gather import gather_rows as jax_gather_rows
from multivae_tpu_torch.data import DataLoader, IncompleteDataset, MultimodalBaseDataset
from multivae_tpu_torch.data import native_gather, prefetch
from multivae_tpu_torch.data.native_gather import gather_rows
from multivae_tpu_torch.data.prefetch import PrefetchLoader
from multivae_tpu_torch.ops import cuda_build

N = 37


@pytest.mark.parametrize("shape,dtype", [
    ((100, 7), np.float32), ((50, 3, 28, 28), np.float32), ((30, 2, 2, 2, 2), np.float64),
    ((40, 600), np.uint8), ((20, 130), np.int64), ((64,), np.int32)])
def test_native_gather_equals_numpy_and_jax(shape, dtype):
    rng = np.random.default_rng(0)
    src = (rng.normal(size=shape) * 100).astype(dtype)
    for idx in (rng.integers(0, shape[0], 40), np.arange(shape[0])[::-1].copy(),
                np.zeros(0, np.int64), np.asarray([3, 3, 3], np.int32)):
        out = gather_rows(src, idx)
        assert out.dtype == src.dtype and out.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(out, src[idx])
        np.testing.assert_array_equal(out, jax_gather_rows(src, idx))
    # more rows than threads times four: the threaded branch
    idx = rng.integers(0, shape[0], 1000)
    np.testing.assert_array_equal(gather_rows(src, idx, n_threads=8), src[idx])
    np.testing.assert_array_equal(gather_rows(src, idx, n_threads=1), src[idx])


@pytest.mark.parametrize("rows,threads", [(1, 1), (891, 1), (892, 2), (4096, 8)])
def test_threads_follow_the_output_bytes(monkeypatch, rows, threads):
    """A thread per whole 4 MiB of output (one at least), at most 8 and the
    host's cores: 892 rows of 9,408 bytes are the first to get two."""
    seen = []

    class Lib:
        def gather_rows(self, src, idx, dst, n_idx, row_bytes, n_threads):
            seen.append(n_threads)

    monkeypatch.setattr(native_gather, "_library", Lib)
    monkeypatch.setattr(native_gather.os, "cpu_count", lambda: 8)
    src = np.zeros((4096, 3, 28, 28), np.float32)   # 9,408 bytes a row
    gather_rows(src, np.arange(rows))
    assert seen == [threads]


def _no_native(monkeypatch):
    def refuse():
        raise AssertionError("the native gather was called")

    monkeypatch.setattr(native_gather, "_library", refuse)


def test_cases_the_c_routine_cannot_take_go_to_numpy(monkeypatch):
    src = np.arange(60, dtype=np.float32).reshape(10, 6)
    _no_native(monkeypatch)
    # negative indices: numpy's wrap-around
    np.testing.assert_array_equal(gather_rows(src, np.asarray([-1, 0, -10])),
                                  src[[-1, 0, -10]])
    # out of range: numpy's IndexError, not a read past the array
    with pytest.raises(IndexError):
        gather_rows(src, np.asarray([0, 10]))
    # a source that is not C-contiguous
    view = src[:, ::2]
    np.testing.assert_array_equal(gather_rows(view, np.asarray([1, 2])), view[[1, 2]])
    # a boolean mask is not a list of rows
    mask = np.arange(10) % 3 == 0
    np.testing.assert_array_equal(gather_rows(src, mask), src[mask])


def test_a_boolean_mask_selects_rows_where_the_jax_gather_reads_rows_0_and_1():
    """The JAX gather casts a boolean mask to int64 (rows 0 and 1 for each
    entry); the port leaves any index that is not an integer to numpy."""
    from multivae_tpu.data import MultimodalBaseDataset as JDataset

    x = np.arange(10 * 128, dtype=np.float32).reshape(10, 128)   # 512-byte rows
    mask = np.arange(10) % 3 == 0
    ours = MultimodalBaseDataset({"a": x}).get_batch(mask)["data"]["a"]
    ref = JDataset({"a": x}).get_batch(mask)["data"]["a"]
    np.testing.assert_array_equal(ours, x[mask])
    assert ref.shape == (10, 128)
    np.testing.assert_array_equal(ref, x[mask.astype(np.int64)])


def test_dataset_takes_rows_of_512_bytes_or_more_natively(monkeypatch):
    calls = []
    real = native_gather.gather_rows
    monkeypatch.setattr(native_gather, "gather_rows",
                        lambda src, idx: calls.append(src.shape) or real(src, idx))
    rng = np.random.default_rng(1)
    data = {"big": rng.random((N, 2, 8, 8), dtype=np.float32),     # 512 bytes a row
            "small": rng.random((N, 127)).astype(np.float32),     # 508 bytes a row
            "text": {"tokens": rng.integers(0, 9, (N, 200)),      # 1,600 bytes a row
                     "padding_mask": np.ones((N, 200), bool)}}     # 200 bytes a row
    ds = MultimodalBaseDataset(data, labels=np.arange(N))
    idx = rng.permutation(N)[:10]
    out = ds.get_batch(idx)
    assert sorted(calls) == [(N, 2, 8, 8), (N, 200)]
    np.testing.assert_array_equal(out["data"]["big"], data["big"][idx])
    np.testing.assert_array_equal(out["data"]["small"], data["small"][idx])
    np.testing.assert_array_equal(out["data"]["text"]["tokens"], data["text"]["tokens"][idx])
    np.testing.assert_array_equal(out["labels"], idx)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A broken source is a build failure, not a silent drop to numpy."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    text = (cuda_build.CSRC_DIR / "gather.cpp").read_text()
    (csrc / "gather.cpp").write_text(text.replace("std::memcpy(", "std::memcpyy("))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(native_gather, "_LIB", None)
    src = np.zeros((10, 200), np.float32)
    with pytest.raises(RuntimeError, match="gather.cpp"):
        gather_rows(src, np.arange(3))
    assert not list((tmp_path / "native").glob("*.so"))


def test_build_without_a_host_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        cuda_build.build(["gather"])


def test_the_library_builds_into_build_native():
    path = cuda_build.library_path("gather")
    assert path.parent == cuda_build.HOST_BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert native_gather.native_available() and path.exists()
    assert shutil.which("g++") or shutil.which("c++")


# --- PrefetchLoader ---------------------------------------------------------

def _dataset(incomplete=False):
    rng = np.random.default_rng(2)
    data = {"a": rng.normal(size=(N, 2)).astype(np.float32),
            "b": rng.normal(size=(N, 3, 4, 4)).astype(np.float32)}
    labels = rng.integers(0, 3, N)
    if incomplete:
        return IncompleteDataset(data, {"a": np.ones(N, bool), "b": rng.random(N) > 0.4},
                                 labels=labels)
    return MultimodalBaseDataset(data, labels=labels)


def _same_batches(ours, ref):
    assert len(ours) == len(ref)
    for x, y in zip(ours, ref):
        assert x.incomplete == y.incomplete
        for m in y.data:
            assert torch.equal(x.data[m], y.data[m]) and torch.equal(x.masks[m], y.masks[m])
        assert torch.equal(x.weights, y.weights) and torch.equal(x.labels, y.labels)


@pytest.mark.parametrize("incomplete", [False, True])
def test_prefetch_yields_the_plain_loaders_batches_in_order(incomplete):
    ds = _dataset(incomplete)
    loader = DataLoader(ds, 8, shuffle=True, seed=1)
    loader.set_epoch(3)
    plain = list(loader)
    pref = PrefetchLoader(DataLoader(ds, 8, shuffle=True, seed=1), "cpu", depth=2)
    pref.set_epoch(3)
    assert len(pref) == len(loader) and pref.dataset is ds
    _same_batches(list(pref), plain)
    _same_batches(list(pref), plain)   # a second epoch over the same loader


def test_prefetch_hands_a_producer_error_to_the_consumer():
    class Broken:
        dataset = None

        def __iter__(self):
            yield from DataLoader(_dataset(), 8, shuffle=False)
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(PrefetchLoader(Broken(), "cpu"))


def test_prefetch_early_exit_leaves_no_thread():
    """An abandoned iteration stops the producer instead of leaving it
    blocked on the full queue."""
    loader = DataLoader(_dataset(), 2, shuffle=False)   # many small batches
    before = threading.active_count()
    for _ in PrefetchLoader(loader, "cpu", depth=1):
        break
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before, "producer thread leaked"


def test_prefetch_reiteration_waits_for_the_previous_producer(monkeypatch):
    """Two producers never iterate one loader at once, even when the first
    outlives the grace join inside the loader's own iteration."""
    monkeypatch.setattr(prefetch, "_JOIN_TIMEOUT", 0.01)

    class SlowLoader:
        def __init__(self, inner):
            self.inner, self.dataset = inner, inner.dataset
            self.active = self.max_active = 0
            self.lock = threading.Lock()

        def set_epoch(self, e):
            self.inner.set_epoch(e)

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            with self.lock:
                self.active += 1
                self.max_active = max(self.max_active, self.active)
            try:
                for b in self.inner:
                    time.sleep(0.2)   # slower than the patched grace join
                    yield b
            finally:
                with self.lock:
                    self.active -= 1

    slow = SlowLoader(DataLoader(_dataset(), 8, shuffle=False))
    pref = PrefetchLoader(slow, "cpu", depth=1)
    it = iter(pref)
    next(it)
    it.close()   # the producer is likely still asleep inside SlowLoader
    assert len(list(pref)) == len(slow)   # must first wait out the first producer
    assert slow.max_active == 1, "two producers iterated concurrently"


def test_host_fields_stay_where_they_are_on_the_cpu():
    """``host_fields`` names the fields the evaluators read on the host; on
    the CPU every field is there already and the batch passes as it is."""
    ds = _dataset()
    plain = list(DataLoader(ds, 8, shuffle=False))
    pref = list(PrefetchLoader(DataLoader(ds, 8, shuffle=False), "cpu",
                               host_fields=("weights", "labels")))
    _same_batches(pref, plain)
    assert all(b.weights.device.type == "cpu" for b in pref)
