"""The port's device cache (``data/device_cache.py``) on the CPU, against
its own host loader and the JAX package's cache.

Batches: the port's cached batches (the trainer's gather and the
evaluators' ``DeviceCachedLoader``) are bit-equal to the port's host
``DataLoader``'s and to the JAX ``DeviceCachedLoader``'s (built on
``get_data_mesh(1)``), for a complete set, an incomplete one with rows
that lack every modality, and CUB's token-dict text, 37 rows in batches of
8 so that the last batch is padded. Training: with ``cache_on_device`` the
port's losses and kept and live weights equal its host run's exactly, and
match the JAX trainer's cached run within float32 noise (the epoch curve
to 1e-4 relative, the weights' moves through
``torch_parity.assert_same_moves``, as in ``test_torch_checkpoint.py``:
MVTCAE on the MLP nets, latent 8, hidden 16, the JAX trainer's noise fed
through ``draw_noise``). Evaluators: a cached coherence sweep equals the
host one exactly and matches the JAX cached evaluator as
``test_torch_metrics.py`` holds the host one. Samplers: the latents
collected from the cache equal the host loop's, 23 rows at batch 8 (as
``tests/test_samplers.py:103`` does for JAX).
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.datasets import CUB as JCUB
from multivae_tpu.data.device_cache import DeviceCachedLoader as JDeviceCachedLoader
from multivae_tpu.data.device_cache import build_device_cache as jax_build_device_cache
from multivae_tpu.data.loader import DataLoader as JDataLoader
from multivae_tpu.metrics import CoherenceEvaluator as JCoherence
from multivae_tpu.metrics import CoherenceEvaluatorConfig as JCoherenceConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.parallel.mesh import get_data_mesh
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import (
    DataLoader,
    DeviceCachedLoader,
    IncompleteDataset,
    MultimodalBaseDataset,
    build_device_cache,
    release_sampler_cache,
)
from multivae_tpu_torch.data.datasets import CUB
from multivae_tpu_torch.data.device_cache import (
    cache_per_device_nbytes,
    estimate_dataset_nbytes,
    upload_plan,
)
from multivae_tpu_torch.metrics import CoherenceEvaluator, CoherenceEvaluatorConfig
from multivae_tpu_torch.models import DMVAE, MMVAE, MVTCAE, DMVAEConfig, MMVAEConfig, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.samplers import GaussianMixtureSampler, GaussianMixtureSamplerConfig
from multivae_tpu_torch.samplers.base import base_sampler
from multivae_tpu_torch.tools import dataset_files
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from test_torch_metrics import N_CLASSES, _run
from test_torch_metrics import world  # noqa: F401  (the metrics tests' models)
from torch_parity import Recorder, assert_same_moves, feed_trainer_noise, normal, port_model, state_of

torch.set_num_threads(2)

N, B = 37, 8   # 37 rows: the last batch of 8 is padded
DIMS = {"a": (4,), "b": (2, 3, 3)}
LATENT, HID, SEED, LR = 8, 16, 11, 1e-3
CURVE_RTOL = 1e-4
LOGGER = "multivae_tpu_torch.data.device_cache"


def _arrays(seed, n=N):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


def _masks(seed, n=N):
    """``b`` missing on ~40% of the rows, and rows 3 and 20 with nothing."""
    rng = np.random.default_rng(seed)
    masks = {"a": np.ones(n, bool), "b": rng.random(n) > 0.4}
    for m in masks:
        masks[m][[3, 20]] = False
    return masks


def _pair_of_datasets(kind, tmp_path=None):
    """(the port's dataset, the JAX package's) of ``kind``."""
    labels = np.random.default_rng(9).integers(0, 3, N)
    if kind == "complete":
        data = _arrays(0)
        return (MultimodalBaseDataset(data, labels=labels), JDataset(data, labels=labels))
    if kind == "incomplete":
        data, masks = _arrays(1), _masks(2)
        for m in data:
            data[m][~masks[m]] = 0.0
        return (IncompleteDataset(data, masks, labels=labels),
                JIncompleteDataset(data, masks, labels=labels))
    src = dataset_files.write_cub(str(tmp_path / "src"), n_train=4, n_test=1, seed=3,
                                  size=(16, 16))
    ref = shutil.copytree(src, tmp_path / "ref")   # each package writes its own vocabulary
    return (CUB(src, "train", max_words_in_caption=12, im_size=(16, 16)),
            JCUB(str(ref), "train", max_words_in_caption=12, im_size=(16, 16)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _batch_arrays(batch):
    """Every field of a batch of either package as numpy, by path."""
    out = dict(_leaves({"data": batch.data, "masks": batch.masks}))
    out["weights"], out["labels"] = batch.weights, batch.labels
    return {k: None if v is None else np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            for k, v in out.items()}


def _assert_same_batches(ours, ref, same_dtypes=True):
    assert len(ours) == len(ref)
    for x, y in zip(ours, ref):
        assert x.incomplete == y.incomplete
        ax, ay = _batch_arrays(x), _batch_arrays(y)
        assert set(ax) == set(ay)
        for k in ay:
            if ay[k] is None:
                assert ax[k] is None, k
                continue
            if same_dtypes:
                assert ax[k].dtype == ay[k].dtype, k
            np.testing.assert_array_equal(ax[k], ay[k], err_msg=k)


@pytest.mark.parametrize("kind", ["complete", "incomplete", "cub"])
def test_cached_batches_are_the_host_loaders_and_the_jax_caches(kind, tmp_path):
    ds, jds = _pair_of_datasets(kind, tmp_path)
    if kind == "cub":
        assert isinstance(ds.get_batch(np.arange(2))["data"]["text"], dict)
    loader = DataLoader(ds, B, shuffle=True, seed=5)
    loader.set_epoch(2)
    host = list(loader)
    assert host[-1].weights.sum() < B   # padded
    cache = build_device_cache(ds, "cpu", 10**9)
    assert cache is not None and cache.incomplete == (kind == "incomplete")
    if kind == "complete":
        assert all(bool((v == 1).all()) for v in cache.masks.values())

    # the trainer's path: the plan uploaded, each row gathered on the device
    idx, weights = upload_plan(loader, "cpu")
    assert idx.dtype == torch.int64
    _assert_same_batches([cache.gather(idx[i], weights[i]) for i in range(len(idx))], host)
    # the evaluators' loader
    _assert_same_batches(list(DeviceCachedLoader(loader, cache)), host)

    jloader = JDataLoader(jds, B, shuffle=True, seed=5)
    jloader.set_epoch(2)
    jcache = jax_build_device_cache(jds, get_data_mesh(1), 10**9)
    assert jcache is not None
    # the same values; the JAX batch holds int32 where the port keeps int64
    _assert_same_batches(host, list(JDeviceCachedLoader(jloader, jcache)), same_dtypes=False)


@pytest.mark.parametrize("process_index", [0, 1])
def test_a_replicated_cache_keeps_the_columns_of_a_global_plan_row(process_index):
    """``take_rows``' ``columns`` (the positions of a plan row kept): a
    global plan row at a process's columns gives that process's host
    batches."""
    ds, _ = _pair_of_datasets("incomplete")
    loader = DataLoader(ds, B, shuffle=True, seed=5, num_processes=2,
                        process_index=process_index)
    cache = build_device_cache(ds, "cpu", 10**9)
    idx, _ = loader.global_epoch_plan()
    _, weights = loader.epoch_plan()
    columns = torch.from_numpy(loader.process_columns().astype(np.int64))
    _assert_same_batches([cache.gather(torch.from_numpy(idx[i].astype(np.int64)),
                                       torch.from_numpy(weights[i]), columns)
                          for i in range(len(idx))], list(loader))


def test_cache_size_and_estimate():
    ds, _ = _pair_of_datasets("incomplete")
    cache = build_device_cache(ds, "cpu", 10**9)
    row = 4 * (4 + 18) + 2 * 1 + 8   # data; the masks as bools; the int64 label
    assert estimate_dataset_nbytes(ds) == N * row
    assert cache_per_device_nbytes(cache) == N * (4 * (4 + 18) + 2 * 4 + 8)


# ----------------------------------------------------------------- training
def _models():
    kw = dict(n_modalities=2, latent_dim=LATENT, input_dims=DIMS,
              decoders_dist={"a": "normal", "b": "laplace"})
    jcfg = {m: JAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    jmodel = JMVTCAE(JMVTCAEConfig(**kw),
                     encoders={m: JEncoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                     decoders={m: JDecoder(c, hidden_dim=HID) for m, c in jcfg.items()},
                     seed=0)
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=LATENT) for m, d in DIMS.items()}
    tmodel = MVTCAE(MVTCAEConfig(**kw),
                    encoders={m: Encoder_VAE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                    decoders={m: Decoder_AE_MLP(c, hidden_dim=HID) for m, c in cfg.items()},
                    device="cpu")
    return jmodel, port_model(jmodel, tmodel)


def _common(**extra):
    kw = dict(num_epochs=3, learning_rate=LR, per_device_train_batch_size=B,
              per_device_eval_batch_size=B, seed=SEED, optimizer_cls="Adam")
    kw.update(extra)
    return kw


def _sets(port=True):
    data, masks = _arrays(1), _masks(2)
    for m in data:
        data[m][~masks[m]] = 0.0
    if port:
        return IncompleteDataset(data, masks), MultimodalBaseDataset(_arrays(4, 12))
    return JIncompleteDataset(data, masks), JDataset(_arrays(4, 12))


def _port_run(out, train=None, eval_set=None, **extra):
    train_set, default_eval = _sets()
    trainer = BaseTrainer(_models()[1], train or train_set, eval_set or default_eval,
                          device="cpu",
                          training_config=BaseTrainerConfig(output_dir=str(out),
                                                            **_common(**extra)))
    trainer.train()
    return trainer


def _assert_same_run(ours, ref):
    assert ours.history == ref.history
    for a, b in ((ours.model.state_dict(), ref.model.state_dict()),
                 (ours._best_state, ref._best_state)):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    return _port_run(tmp_path_factory.mktemp("host"))


def test_cached_training_equals_host_training_exactly(host_run, tmp_path):
    """An incomplete train set (masks, dead rows, a padded batch) and a
    complete eval set, 3 epochs: the same losses, bit for bit, and the same
    kept and live weights."""
    cached = _port_run(tmp_path, cache_on_device=True)
    assert cached._train_cache is not None and cached._eval_cache is not None
    assert cached.train_dataset._sampler_device_cache is cached._train_cache
    _assert_same_run(cached, host_run)


def test_cached_training_matches_the_jax_cached_trainer(tmp_path):
    jmodel, tmodel = _models()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    rec = Recorder()
    jtrain, jeval = _sets(port=False)
    jtrainer = JTrainer(jmodel, jtrain, jeval, callbacks=[rec],
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1, cache_on_device=True,
                                                       **_common()))
    assert jtrainer._train_cache is not None
    jtrainer.train()
    train, eval_set = _sets()
    trainer = BaseTrainer(tmodel, train, eval_set, device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "torch"), cache_on_device=True,
                              **_common()))
    feed_trainer_noise(trainer, tmodel,
                       lambda key: (lambda shape, generator=None: normal(key, shape)), SEED)
    trainer.train()
    assert trainer._train_cache is not None
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        np.testing.assert_allclose([h[key] for h in trainer.history],
                                   [h[key] for h in rec.logs], rtol=CURVE_RTOL, err_msg=key)
    assert_same_moves(trainer.model.state_dict(), state_of(jtrainer.state.params), start, LR)
    assert_same_moves(trainer._best_state, state_of(jtrainer.best_params), start, LR)


def test_over_budget_falls_back_with_a_warning(host_run, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        trainer = _port_run(tmp_path, cache_on_device=True, device_cache_budget_gb=1e-9)
    assert trainer._train_cache is None and trainer._eval_cache is None
    assert sum("exceeds the device cache budget" in r.message for r in caplog.records) == 2
    _assert_same_run(trainer, host_run)


@pytest.mark.parametrize("fits", ["eval only", "train only"])
def test_the_eval_cache_has_its_own_budget(host_run, tmp_path, caplog, fits):
    """The eval set gets what the train cache leaves of the budget: all of
    it when the train set fell back, and nothing to spare when the train
    cache took it. The set that falls back says so."""
    train, eval_set = _sets()
    n_train, n_eval = estimate_dataset_nbytes(train), estimate_dataset_nbytes(eval_set)
    assert n_eval < n_train
    budget = (n_eval if fits == "eval only" else n_train + n_eval // 2) / 1e9
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        trainer = _port_run(tmp_path, cache_on_device=True, device_cache_budget_gb=budget)
    assert sum("exceeds the device cache budget" in r.message for r in caplog.records) == 1
    assert (trainer._train_cache is None) == (fits == "eval only")
    assert (trainer._eval_cache is None) == (fits == "train only")
    _assert_same_run(trainer, host_run)


class _NoBulk(IncompleteDataset):
    """A dataset that reads at most a batch at a time."""

    def get_batch(self, indices):
        if len(indices) > B:
            raise RuntimeError("streaming only")
        return super().get_batch(indices)


def test_an_unindexable_dataset_falls_back_with_a_warning(host_run, tmp_path, caplog):
    train, _ = _sets()
    streaming = _NoBulk(train.data, {m: v for m, v in train.masks.items()})
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert build_device_cache(streaming, "cpu", 10**9, chunk=16) is None
        trainer = _port_run(tmp_path, train=streaming, cache_on_device=True)
    assert sum("failed bulk indexing" in r.message for r in caplog.records) == 2
    assert trainer._train_cache is None and trainer._eval_cache is not None
    _assert_same_run(trainer, host_run)


def test_layouts():
    """A typo is refused by the config and by the build; on one device
    "sharded" keeps the whole set, as "replicated" and "auto" do."""
    with pytest.raises(AttributeError, match="device_cache_layout"):
        BaseTrainerConfig(device_cache_layout="row-sharded")
    ds, _ = _pair_of_datasets("complete")
    with pytest.raises(ValueError, match="device cache layout"):
        build_device_cache(ds, "cpu", 10**9, layout="Sharded")
    whole = build_device_cache(ds, "cpu", 10**9)
    for layout in ("replicated", "sharded"):
        cache = build_device_cache(ds, "cpu", 10**9, layout=layout)
        assert cache_per_device_nbytes(cache) == cache_per_device_nbytes(whole)
        assert all(torch.equal(cache.data[m], whole.data[m]) for m in whole.data)


def test_a_jax_training_config_with_the_cache_fields_loads(tmp_path):
    """The three cache fields of a JAX ``training_config.json`` load, and
    with them ``steps_per_execution``, ``pipeline_epochs``,
    ``pipeline_depth`` and ``mixed_precision``; the file loads unedited,
    its TPU fields at their defaults too, as does one saved by the JAX
    ``BaseTrainerConfig()``. With ``fsdp=True`` it builds a trainer (one
    process, a data axis of one) that trains as the replicated one does,
    bit for bit; ``n_model_devices=2`` loads, and
    building a trainer from it in one process raises for the missing group;
    with ``checkpoint_backend="orbax"`` it builds a trainer that writes its
    train state sharded, ``train_state/`` and no whole optimizer file."""
    JTrainerConfig(output_dir="out", n_devices=1, cache_on_device=True,
                   device_cache_budget_gb=2.5, device_cache_layout="sharded",
                   steps_per_execution=4, pipeline_depth=3,
                   mixed_precision=True).save_json(
        str(tmp_path), "training_config")
    with open(tmp_path / "training_config.json") as f:
        saved = json.load(f)
    ported = set(BaseTrainerConfig().to_dict())
    assert not set(saved) - ported - {"name"}
    assert {"fsdp", "n_model_devices", "checkpoint_backend", "async_checkpointing",
            "cache_on_device"} <= ported
    cfg = BaseTrainerConfig.from_json_file(str(tmp_path / "training_config.json"))
    assert (cfg.cache_on_device, cfg.device_cache_budget_gb, cfg.device_cache_layout) == (
        True, 2.5, "sharded")
    assert (cfg.steps_per_execution, cfg.pipeline_epochs, cfg.pipeline_depth) == (4, True, 3)
    assert cfg.mixed_precision is True
    assert (cfg.fsdp, cfg.n_model_devices, cfg.checkpoint_backend,
            cfg.async_checkpointing) == (False, 1, "msgpack", True)
    JTrainerConfig().save_json(str(tmp_path / "defaults"), "training_config")
    defaults = BaseTrainerConfig.from_json_file(
        str(tmp_path / "defaults" / "training_config.json"))
    assert defaults.to_dict() == BaseTrainerConfig().to_dict()
    assert BaseTrainerConfig.from_dict(dict(saved, async_checkpointing=False)).async_checkpointing \
        is False
    runs = {}
    for fsdp in (False, True):
        config = BaseTrainerConfig.from_dict(dict(
            saved, fsdp=fsdp, output_dir=str(tmp_path / f"fsdp_{fsdp}"),
            **_common(num_epochs=2)))
        assert config.fsdp is fsdp
        train_set, eval_set = _sets()
        trainer = BaseTrainer(_models()[1], train_set, eval_set, device="cpu",
                              training_config=config)
        assert (trainer._state is not None) is fsdp
        if fsdp:   # every leaf judged by the JAX rule (this model's are too small to cut)
            assert set(trainer._state.placements) == {
                name for name, _ in trainer.model.named_parameters()}
        trainer.train()
        runs[fsdp] = trainer
    _assert_same_run(runs[True], runs[False])
    model_axis = BaseTrainerConfig.from_dict(dict(saved, n_model_devices=2))
    assert model_axis.n_model_devices == 2
    with pytest.raises(ValueError, match="n_model_devices=2 but no process group"):
        BaseTrainer(_models()[1], *_sets(), device="cpu", training_config=model_axis)
    orbax = BaseTrainerConfig.from_dict(dict(
        saved, checkpoint_backend="orbax", output_dir=str(tmp_path / "orbax"),
        **_common(num_epochs=1, steps_saving=1)))
    assert (orbax.checkpoint_backend, orbax.async_checkpointing) == ("orbax", True)
    trainer = BaseTrainer(_models()[1], *_sets(), device="cpu", training_config=orbax)
    trainer.train()
    checkpoint = os.path.join(trainer.training_dir, "checkpoint_epoch_1")
    assert os.path.isdir(os.path.join(checkpoint, "train_state"))
    assert not {"optimizer.pt", "live_params.pt"} & set(os.listdir(checkpoint))
    # the JAX package's own checks, with its messages
    with pytest.raises(AttributeError, match="checkpoint_backend must be"):
        BaseTrainerConfig(checkpoint_backend="pickle")
    with pytest.raises(AttributeError, match="n_model_devices must be a positive"):
        BaseTrainerConfig(n_model_devices=0)


# --------------------------------------------------------------- evaluators
def _coherence(world, family, lib, cache_on_device, **kw):  # noqa: F811
    ds_cls = JDataset if lib == "jax" else MultimodalBaseDataset
    ds = ds_cls(world["data"], labels=world["labels"])
    if lib == "jax":
        return lambda model: JCoherence(
            model, world["jclfs"], ds, eval_config=JCoherenceConfig(
                num_classes=N_CLASSES, batch_size=12, fused_sweep=False,
                nb_samples_for_joint=26, cache_on_device=cache_on_device)).eval
    return lambda model: CoherenceEvaluator(
        model, world["tclfs"], ds, eval_config=CoherenceEvaluatorConfig(
            num_classes=N_CLASSES, batch_size=12, nb_samples_for_joint=26,
            cache_on_device=cache_on_device), **kw).eval


def test_the_cached_evaluator_equals_the_host_one_and_the_jax_cached_one(world):  # noqa: F811
    """The coherences of MVTCAE (30 rows in batches of 12, the last padded):
    the port's cached sweep equals its host sweep on the same generator,
    and matches the JAX evaluator with its cache on the same draws; the
    accuracies are counts, so exactly."""
    _, tmodel = world["models"]["mvtcae"]
    host, cached = (_coherence(world, "mvtcae", "torch", c,
                               generator=torch.Generator().manual_seed(4))(tmodel)
                    for c in (False, True))
    assert isinstance(cached.__self__.test_loader, DeviceCachedLoader)
    assert not isinstance(host.__self__.test_loader, DeviceCachedLoader)
    assert dict(cached()) == dict(host())
    ref, out = _run(world, "mvtcae", _coherence(world, "mvtcae", "jax", True),
                    _coherence(world, "mvtcae", "torch", True))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=0, abs=1e-12), k


# ----------------------------------------------------------------- samplers
def _latents(sampler, ds, device, seed=7):
    return sampler._collect_latents(ds, batch_size=8, device=device,
                                    generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("family", ["mvtcae", "dmvae"])
@pytest.mark.parametrize("kind", ["complete", "incomplete"])
def test_collected_latents_equal_the_host_loop(family, kind):
    """23 rows at batch 8 (a padded tail), with the same generator; the
    incomplete set through the per-sample encode, DMVAE's private codes
    too; the cache is memoized on the dataset and dropped by
    ``release_sampler_cache``."""
    data = {m: v[:23] for m, v in _arrays(1).items()}
    if kind == "complete":
        ds = MultimodalBaseDataset(data)
    else:
        masks = {m: v[:23] for m, v in _masks(2).items()}
        ds = IncompleteDataset({m: data[m] * masks[m].reshape(-1, *[1] * (data[m].ndim - 1))
                                for m in data}, masks)
    common = dict(n_modalities=2, latent_dim=4, input_dims=DIMS)
    model = (MVTCAE(MVTCAEConfig(**common), device="cpu") if family == "mvtcae" else
             DMVAE(DMVAEConfig(modalities_specific_dim={"a": 1, "b": 2}, **common),
                   device="cpu"))
    sampler = GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(n_components=2))
    z, mods = _latents(sampler, ds, device=True)
    cache = ds._sampler_device_cache
    assert cache is not None and cache.incomplete == (kind == "incomplete")
    z_host, mods_host = _latents(sampler, ds, device=False)
    assert z.shape == (23, 4) and torch.equal(z, z_host)
    assert (mods is None) == (family == "mvtcae")
    if mods is not None:
        assert set(mods) == set(mods_host) == {"a", "b"}
        assert all(torch.equal(mods[m], mods_host[m]) for m in mods)
    # a second collection reuses the memoized cache
    assert torch.equal(_latents(sampler, ds, device=True)[0], z)
    assert ds._sampler_device_cache is cache
    assert release_sampler_cache(ds) and ds._sampler_device_cache is None
    assert not release_sampler_cache(ds)


def test_a_fit_reuses_the_trainers_cache(host_run, monkeypatch, tmp_path):
    trainer = _port_run(tmp_path, cache_on_device=True, num_epochs=1)
    ds = trainer.train_dataset
    monkeypatch.setattr(base_sampler, "build_device_cache",
                        lambda *a, **k: pytest.fail("a second upload"))
    sampler = GaussianMixtureSampler(trainer.model,
                                     GaussianMixtureSamplerConfig(n_components=2))
    sampler.fit(ds)
    assert sampler.is_fitted and ds._sampler_device_cache is trainer._train_cache


def test_a_mixture_model_still_refuses_incomplete_data():
    ds = _sets()[0]
    model = MMVAE(MMVAEConfig(n_modalities=2, latent_dim=4, input_dims=DIMS), device="cpu")
    sampler = GaussianMixtureSampler(model, GaussianMixtureSamplerConfig(n_components=2))
    with pytest.raises(AttributeError):
        sampler.fit(ds)
    # the device path declined the incomplete cache; the host loop raised
    assert ds._sampler_device_cache is not None and ds._sampler_device_cache.incomplete
