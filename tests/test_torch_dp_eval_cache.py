"""The rest of the port's data-parallel surface on the CPU, over gloo: the
chunked loop (``steps_per_execution``) under a process group, the
row-sharded device cache over ranks, and the evaluators' ``n_devices``,
against one process and against the JAX package at ``n_devices=2`` (the
conftest's virtual CPU devices).

Two worker processes (``torch_dp_worker.py --cases torch_dp_eval_cases``),
spawned once for the module, run every job of ``torch_dp_eval_cases`` as
the two ranks of one gloo group and save each result; each test reads its
job's result as soon as it is written. The test process runs the
one-process references and the JAX package.

- (a) MVAE and MMVAE of ``torch_dp_cases`` (three tiny modalities) on the
  device cache at ``steps_per_execution`` 3 and 8 under two ranks: the
  step-by-step loop's history, kept and live weights, bit for bit (on the
  CPU a chunk runs its steps eagerly, the same collectives in the same
  order). MVAE chunked (3 steps) on the JAX cached trainer's draws against
  that trainer at ``n_devices=2``: the epoch losses to 1e-4 and the kept
  weights by ``assert_same_moves`` (float32 drift over Adam steps of two
  implementations, as ``test_torch_steps_per_execution.py`` holds it).
- (b) The replicated, row-sharded and "auto" (a budget only the sharded
  layout fits) caches under two ranks: each rank's batches of two epochs
  bit-equal to the host loader's columns and to the JAX row-sharded
  ``DeviceCachedLoader``'s at ``n_devices=2``; a sharded block holds
  ceil(37 / 2) = 19 of the 37 rows; MVTCAE trained from the sharded and
  "auto" caches bit-equal to the replicated run. Where rank 1 cannot index
  the dataset in bulk, the sharded cache falls back on both ranks.
- (c) Every evaluator on MLP MVTCAE and MMVAE (three image modalities, 30
  rows in batches of 12: the last batch's 6 real rows on rank 0, its 6
  padding rows on rank 1) at ``n_devices=2`` over the ranks: the two ranks
  return the same metrics, equal to one process's from the same generator
  where they are counts (coherences, cluster accuracy) and within
  ``SUM_TOL`` where the ranks' sums reorder (NLL, SSIM, MSE, Fréchet
  distance); and fed the JAX model's draws, equal to the JAX evaluators at
  ``n_devices=2`` within ``test_torch_metrics.py``'s tolerances. At
  ``n_devices=1`` (the default) under the two ranks, each rank evaluates
  alone, as one process.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dp_cases as cases
import torch_dp_eval_cases as ev
from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.device_cache import DeviceCachedLoader as JDeviceCachedLoader
from multivae_tpu.data.device_cache import build_device_cache as jax_build_device_cache
from multivae_tpu.data.loader import DataLoader as JDataLoader
from multivae_tpu.metrics import (
    Clustering as JClustering,
    ClusteringConfig as JClusteringConfig,
    CoherenceEvaluator as JCoherence,
    CoherenceEvaluatorConfig as JCoherenceConfig,
    FIDEvaluator as JFIDEvaluator,
    FIDEvaluatorConfig as JFIDEvaluatorConfig,
    LikelihoodsEvaluator as JLikelihoods,
    LikelihoodsEvaluatorConfig as JLikelihoodsConfig,
    Reconstruction as JReconstruction,
    ReconstructionConfig as JReconstructionConfig,
)
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MVAE as JMVAE
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVAEConfig as JMVAEConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.parallel.mesh import get_data_mesh as jax_data_mesh
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import DataLoader
from torch_parity import Recorder, assert_same_moves, record_keys, state_of

TIMEOUT = 150              # seconds a worker may run
WORLD = ev.WORLD
TESTS = os.path.dirname(os.path.abspath(__file__))
# metrics whose sums the ranks take in another order than one process (the
# NLL, SSIM, MSE, Fréchet distance): float32 terms, rtol 1e-5 as
# test_torch_metrics.py holds the port to JAX; counts are exact
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
NLL_TOL = dict(rtol=1e-5, atol=1e-4)
COUNTED = ("coherence", "clustering")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_eval_model(family):
    nets = ({m: JEncoder(JAEConfig(input_dim=d, latent_dim=ev.LATENT), hidden_dim=ev.HID)
             for m, d in ev.DIMS.items()},
            {m: JDecoder(JAEConfig(input_dim=d, latent_dim=ev.LATENT), hidden_dim=ev.HID)
             for m, d in ev.DIMS.items()})
    cls, config = (JMMVAE, JMMVAEConfig) if family == "mmvae" else (JMVTCAE, JMVTCAEConfig)
    return cls(config(**ev.model_kwargs(family)), *nets, seed=1)


class _Workers:
    """The two worker processes, the JAX models they start from and the
    folder of their results."""

    def __init__(self, out):
        self.out = str(out)
        spec = os.path.join(self.out, "states.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(TESTS), TESTS, os.environ.get("PYTHONPATH", "")]))
        port = str(_free_port())
        self.deadline = time.monotonic() + TIMEOUT
        self.procs, self.logs = [], []
        for rank in range(WORLD):
            logs = [os.path.join(self.out, f"worker{rank}.{s}") for s in ("stdout", "stderr")]
            self.logs.append(logs)
            with open(logs[0], "w") as out, open(logs[1], "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(TESTS, "torch_dp_worker.py"), str(rank),
                     str(WORLD), port, self.out, spec, "--cases", "torch_dp_eval_cases"],
                    env=env, stdout=out, stderr=err))
        # the JAX models, while the workers run their first jobs
        self.jax = {f: _jax_eval_model(f) for f in ev.FAMILIES}
        self.jax["mvae"] = JMVAE(JMVAEConfig(**cases.BASE, **cases.FAMILIES["MVAE"][0]), seed=0)
        self.states = {f: state_of(m.params) for f, m in self.jax.items()}
        torch.save(self.states, spec + ".part")
        os.replace(spec + ".part", spec)

    def load(self, name: str, rank: int) -> dict:
        """Rank ``rank``'s result of ``name``, waiting for it until the
        deadline; a job that raised fails with its traceback."""
        path = os.path.join(self.out, f"{name}_rank{rank}")
        while not os.path.exists(path + ".pt"):
            if os.path.exists(path + ".err"):
                with open(path + ".err") as f:
                    pytest.fail(f"rank {rank} failed {name}:\n{f.read()}")
            if any(p.poll() is not None for p in self.procs) or time.monotonic() > self.deadline:
                self.close()
                pytest.fail(f"no result {name} of rank {rank}:\n{self.stderr()}")
            time.sleep(0.05)
        return cases.load(self.out, name, rank)

    def both(self, name: str):
        return [self.load(name, rank) for rank in range(WORLD)]

    def stderr(self) -> str:
        self.close()
        out = []
        for _, err in self.logs:
            with open(err) as f:
                out.append(f.read()[-3000:])
        return "\n".join(out)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    handle = _Workers(tmp_path_factory.mktemp("dp_eval_cache"))
    yield handle
    handle.close()


def _same_weights(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k


# ------------------------------------------------------------ (a) chunks
def test_mvae_chunked_under_two_ranks_matches_the_jax_cached_trainer(workers, tmp_path):
    """The JAX cached trainer at ``n_devices=2`` in chunks of 3 steps, its
    draws fed to both ranks: the epoch losses to 1e-4, the kept weights'
    moves by ``assert_same_moves``."""
    jmodel = workers.jax["mvae"]
    start = state_of(jmodel.params)
    (data, masks), (eval_data, eval_masks) = cases.arrays(True, seed=1)
    rec = Recorder()
    jtrainer = JTrainer(jmodel, JIncompleteDataset(data, masks),
                        JIncompleteDataset(eval_data, eval_masks),
                        callbacks=[rec], training_config=JTrainerConfig(
                            output_dir=str(tmp_path), n_devices=WORLD, **ev.MVAE_FED))
    assert jtrainer.n_data_devices == WORLD
    jtrainer.train()
    ranks = workers.both("mvae_fed")
    n_steps = ev.MVAE_FED["num_epochs"] * -(-cases.N_TRAIN // (WORLD * cases.PER_DEVICE))
    assert ranks[0]["steps"] == ranks[1]["steps"] == n_steps
    for key in ("train_epoch_loss", "eval_epoch_loss"):
        ours = [h[key] for h in ranks[0]["history"]]
        assert ours == [h[key] for h in ranks[1]["history"]]
        np.testing.assert_allclose(ours, [h[key] for h in rec.logs], rtol=1e-4, err_msg=key)
    assert_same_moves(ranks[0]["best"], state_of(jtrainer.best_params), start,
                      ev.MVAE_FED["learning_rate"])


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("family", list(ev.CHUNKED_FAMILIES))
def test_the_chunked_loop_under_two_ranks_equals_the_step_by_step_loop(workers, family, n):
    """History, kept and live weights and SGD's momentum of the chunked run
    bit-equal to the step-by-step run, both under two ranks, whose replicas
    agree."""
    ref = workers.load(f"chunk_{family}_1", 0)
    ranks = workers.both(f"chunk_{family}_{n}")
    assert ranks[0]["world"] == WORLD and ranks[0]["history"] == ranks[1]["history"]
    assert len(ref["history"]) == cases.EPOCHS and ranks[0]["history"] == ref["history"]
    for key in ("live", "best", "momentum"):
        _same_weights(ranks[0][key], ref[key])
    _same_weights(ranks[1]["live"], ranks[0]["live"])
    assert ranks[0]["lrs"] == ref["lrs"]


def test_jnf_hmc_encode_on_two_ranks_equals_one_process(workers):
    """JNF's encode from a subset (the expert a row, the noise, the HMC
    momenta and accept draws, each of the global batch's rows in K=2
    blocks, each rank keeping its own): each rank's latents are one
    process's at its rows, to float32 noise (the MADE passes see 8 rows
    where one process sees 16)."""
    ref = ev.jnf_encode()
    assert ref.shape == (2, ev.JNF_ROWS, cases.BASE["latent_dim"])
    half = ev.JNF_ROWS // WORLD
    for rank, result in enumerate(workers.both("jnf_encode")):
        np.testing.assert_allclose(result["z"].numpy(),
                                   ref[:, rank * half:(rank + 1) * half].numpy(),
                                   rtol=1e-5, atol=1e-6)


# ----------------------------------------------------- (b) the sharded cache
@pytest.fixture(scope="module")
def jax_sharded_batches():
    """The JAX row-sharded cache's global batches at ``n_devices=2`` over
    ``plan_batches``' two epochs, as numpy arrays."""
    (data, masks), _ = cases.arrays(True)
    ds = JIncompleteDataset(data, masks)
    mesh = jax_data_mesh(WORLD)
    cache = jax_build_device_cache(ds, mesh, 10**9, layout="sharded")
    loader = JDeviceCachedLoader(JDataLoader(ds, cases.PER_DEVICE * WORLD, shuffle=True, seed=5),
                                 cache, mesh=mesh)
    out = []
    for epoch in ev.PLAN_EPOCHS:
        loader.set_epoch(epoch)
        out += [{"data": {m: np.asarray(v) for m, v in b.data.items()},
                 "masks": {m: np.asarray(v) for m, v in b.masks.items()},
                 "weights": np.asarray(b.weights)} for b in loader]
    return out


@pytest.mark.parametrize("layout", list(ev.LAYOUTS))
def test_cached_batches_over_two_ranks_equal_the_host_loader_and_the_jax_sharded_cache(
        workers, jax_sharded_batches, layout):
    """Each rank's batches: the host loader's at its columns and the JAX
    sharded cache's global batch at its columns, bit for bit (data in
    float32, masks as the cache's floats); the sharded and "auto" caches
    hold a block of 19 rows."""
    train, _ = cases.datasets(True)
    for rank, result in enumerate(workers.both(f"layout_{layout}")):
        kind = "DeviceDataCache" if layout == "replicated" else "ShardedDeviceDataCache"
        assert result["kind"] == kind
        whole = workers.load("layout_replicated", rank)["nbytes"]
        assert result["nbytes"] == (whole if layout == "replicated"
                                    else whole // cases.N_TRAIN * 19)
        loader = DataLoader(train, cases.PER_DEVICE * WORLD, shuffle=True, seed=5,
                            num_processes=WORLD, process_index=rank)
        host = []
        for epoch in ev.PLAN_EPOCHS:
            loader.set_epoch(epoch)
            host += list(loader)
        cols = loader.process_columns()
        assert len(result["batches"]) == len(host) == len(jax_sharded_batches)
        for ours, theirs, jax_batch in zip(result["batches"], host, jax_sharded_batches):
            assert torch.equal(ours["weights"], theirs.weights)
            np.testing.assert_array_equal(ours["weights"].numpy(), jax_batch["weights"][cols])
            for m, v in ours["data"].items():
                assert torch.equal(v, theirs.data[m]), m
                np.testing.assert_array_equal(v.numpy(), jax_batch["data"][m][cols])
                assert torch.equal(ours["masks"][m], theirs.masks[m].float()), m
                np.testing.assert_array_equal(ours["masks"][m].numpy(),
                                              jax_batch["masks"][m][cols])


@pytest.mark.parametrize("layout", ["sharded", "auto"])
def test_training_on_the_sharded_cache_equals_the_replicated_one(workers, layout):
    """MVTCAE under two ranks from a row-sharded train and eval cache (asked
    for, or the "auto" layout's choice under its budget): the replicated
    run's history, kept and live weights and momentum, bit for bit."""
    ref = workers.load("layout_replicated", 0)
    assert ref["caches"]["train"][0] == ref["caches"]["eval"][0] == "DeviceDataCache"
    for result in workers.both(f"layout_{layout}"):
        assert result["caches"]["train"][0] == result["caches"]["eval"][0] == (
            "ShardedDeviceDataCache")
        assert result["history"] == ref["history"]
        for key in ("live", "best", "momentum"):
            _same_weights(result[key], ref[key])


def test_a_sharded_cache_falls_back_on_every_rank_where_one_rank_cannot_build_it(workers):
    """Rank 1 cannot index the dataset in bulk: the sharded cache falls
    back to the host loader on both ranks (its steps are collectives of
    both), and the group still meets; a replicated cache falls back on
    rank 1 alone."""
    ranks = workers.both("fallback")
    assert [r["sharded"] for r in ranks] == [None, None]
    assert [r["replicated"] for r in ranks] == ["DeviceDataCache", None]


# ----------------------------------------------------------- (c) evaluators
def _assert_metrics(ours: dict, ref: dict, evaluator: str, tol):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if evaluator in COUNTED:
            assert ours[k] == pytest.approx(v, rel=0, abs=1e-12), k
        else:
            np.testing.assert_allclose(ours[k], v, err_msg=k, **tol)


@pytest.mark.parametrize("evaluator", list(ev.EVALUATORS))
@pytest.mark.parametrize("family", list(ev.FAMILIES))
def test_evaluators_over_two_ranks_equal_one_process(workers, family, evaluator):
    """Both ranks return the same metrics, those of one process on the same
    batches and generator: counts exactly, sums within ``SUM_TOL``."""
    ranks = workers.both("evaluators")
    ours = ranks[0][(family, evaluator)]
    assert ranks[1][(family, evaluator)] == ours
    ref = ev.port_metrics(family, evaluator, workers.states[family], n_devices=1)
    _assert_metrics(ours, ref, evaluator, SUM_TOL)


@pytest.mark.parametrize("evaluator", list(ev.EVALUATORS) + ["default"])
def test_evaluators_at_one_device_under_two_ranks_evaluate_alone(workers, evaluator):
    """``n_devices=1`` (the default config too) under a group of two: each
    rank evaluates every row alone, as one process does (the JAX
    evaluator's one device)."""
    state = workers.states["mvtcae"]
    ref = (ev.default_reconstruction(state) if evaluator == "default"
           else ev.port_metrics("mvtcae", evaluator, state, n_devices=1))
    for result in workers.both("alone"):
        _assert_metrics(result[evaluator], ref, evaluator, SUM_TOL)


def _jax_call(family, evaluator, jmodel, tmodel_state):
    """The JAX evaluator of ``evaluator_call``'s settings at ``n_devices=2``
    (the per-subset loop, the test set on the host)."""
    data, labels, train, train_labels, weights = ev.eval_arrays()
    ds = JDataset(data, labels=labels)
    common = dict(batch_size=ev.BATCH, n_devices=WORLD, cache_on_device=False)
    clfs = {m: (lambda x, w=w: jnp.asarray(x).reshape(len(x), -1) @ w) for m, w in weights.items()}
    if evaluator == "likelihoods":
        return JLikelihoods(jmodel, ds, eval_config=JLikelihoodsConfig(
            num_samples=5, batch_size_k=2, unified_implementation=family == "mvtcae",
            **common)).eval
    if evaluator == "coherence":
        return JCoherence(jmodel, clfs, ds, eval_config=JCoherenceConfig(
            num_classes=ev.N_CLASSES, nb_samples_for_joint=26, nb_samples_for_cross=2,
            fused_sweep=False, **common)).eval
    if evaluator == "reconstruction":
        return JReconstruction(jmodel, ds, eval_config=JReconstructionConfig(
            metric="SSIM" if family == "mvtcae" else "MSE", fused_sweep=False, **common)).eval
    if evaluator == "fid":
        fid = JFIDEvaluator(jmodel, ds, custom_encoders=clfs, eval_config=JFIDEvaluatorConfig(
            fused_sweep=False, **common))
        return lambda: fid.compute_all_conditional_fids("m0")
    from sklearn.cluster import KMeans as SKMeans

    clustering = JClustering(jmodel, ds, JDataset(train, labels=train_labels),
                             eval_config=JClusteringConfig(n_clusters=ev.N_CLASSES,
                                                           number_of_runs=2, **common))
    init = ev.kmeans_init(ev.port_model(family, tmodel_state), train)
    clustering.clustering = SKMeans(n_clusters=ev.N_CLASSES, init=init.numpy(), n_init=1,
                                    max_iter=300)
    return clustering.eval


@pytest.mark.parametrize("family,evaluator", list(ev.JAX_CASES))
def test_evaluators_over_two_ranks_equal_jax_on_two_devices(workers, family, evaluator):
    """The JAX evaluator at ``n_devices=2`` with its keys logged, against
    both ranks fed those keys' draws: counts exactly, values within
    ``VALUE_TOL``, the NLL within ``NLL_TOL``."""
    jmodel = workers.jax[family]
    jmodel.set_seed(ev.JAX_SEED)
    keys = record_keys(jmodel)
    try:
        ref = {k: float(v) for k, v in _jax_call(family, evaluator, jmodel,
                                                 workers.states[family])().items()}
    finally:
        del jmodel.next_rng
    assert len(keys) <= 64   # the keys the ranks draw from
    ranks = workers.both("fed")
    assert ranks[1][(family, evaluator)] == ranks[0][(family, evaluator)]
    _assert_metrics(ranks[0][(family, evaluator)], ref, evaluator,
                    NLL_TOL if evaluator == "likelihoods" else VALUE_TOL)


def test_the_workers_end_cleanly(workers):
    """Both workers ran every job without an error and left the group."""
    for p in workers.procs:
        p.wait(timeout=max(workers.deadline - time.monotonic(), 1))
    for rank, p in enumerate(workers.procs):
        with open(workers.logs[rank][0]) as f:
            out = f.read()
        assert p.returncode == 0 and "DONE" in out, workers.stderr()
    assert not [f for f in os.listdir(workers.out) if f.endswith(".err")]
