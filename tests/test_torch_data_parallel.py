"""Data-parallel training in the port (``multivae_tpu_torch/parallel``) on the
CPU, over gloo: two ranks with ``per_device_train_batch_size`` 8 give the
run of one process on the global batch of 16, as N devices give one device's
run in the JAX package (``tests/test_trainer.py``,
``tests/test_two_process_distributed.py``).

The two ranks are worker processes (``torch_dp_worker.py``), spawned once
for the module: they run every case of ``torch_dp_cases`` and save each
result, and each test reads its case's as soon as it is written. The
first case's trainer opens their group from the coordinator fields of its
config; each worker is killed after ``TIMEOUT`` seconds.

- Each of the 14 families (and MoPoE's complete-data split, MMVAE's
  microbatched step, the device cache) against one process: the logged
  losses and metrics of every epoch to ``HISTORY_TOL`` (float32 summation
  order: the ranks add their halves of each sum apart); the live and kept
  weights' moves and SGD's momentum buffers to ``MOVE_TOL`` of their norm
  (the moves are linear in the gradients, whose sums differ in the same
  order); the two ranks' replicas bit-equal; the same rates. The last
  batch's 11 padding rows fall 3 on rank 0 and 8, all of its rows, on rank
  1.
- MVTCAE and MMVAE (DReG) against the JAX trainer at ``n_devices=2`` on the
  conftest's virtual CPU devices, the JAX draws fed to both ranks: the
  losses to 1e-4 and the kept weights' moves by ``assert_same_moves``, as
  the one-process port tests hold them (float32 drift over Adam steps of
  two implementations).
- A two-rank resume from rank 0's checkpoint equals the uninterrupted
  two-rank run; only rank 0 fires the writing events.
- The loader's plans against the JAX loader's, the refusals, and a JAX
  ``training_config.json`` with the four parallel fields.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_dp_cases as cases
from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data.loader import DataLoader as JDataLoader
from multivae_tpu.models import MMVAE as JMMVAE
from multivae_tpu.models import MMVAEConfig as JMMVAEConfig
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import MultimodalBaseDataset, batch_from_arrays
from multivae_tpu_torch.data.loader import DataLoader
from multivae_tpu_torch.parallel import DataShard, get_data_mesh, shard_batch
from multivae_tpu_torch.trainers import BaseTrainerConfig
from torch_dp_jax import COMMON, FED, SEED
from torch_parity import Recorder, assert_same_moves, state_of

TIMEOUT = 120              # seconds a worker may run
WORLD = 2
HISTORY_TOL = dict(rtol=1e-5, atol=1e-6)
MOVE_TOL = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
JAX_MODELS = {"MVTCAE": (JMVTCAE, JMVTCAEConfig), "MMVAE": (JMMVAE, JMMVAEConfig)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Workers:
    """The two worker processes and the folder of their results."""

    def __init__(self, out):
        self.out = str(out)
        self.deadline = time.monotonic() + TIMEOUT
        specs = {}
        for family in FED:
            path = os.path.join(self.out, f"init_{family}.pt")
            torch.save(state_of(_jax_model(family).params), path)
            specs[f"jax_{family}"] = {"family": family, "init": path}
        spec_path = os.path.join(self.out, "jax_cases.json")
        with open(spec_path, "w") as f:
            json.dump(specs, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(TESTS), TESTS, os.environ.get("PYTHONPATH", "")]))
        port = str(_free_port())
        # their output goes to files: a full pipe would stop a worker
        self.logs = [os.path.join(self.out, f"worker{rank}.{stream}")
                     for rank in range(WORLD) for stream in ("stdout", "stderr")]
        self.procs = []
        for rank in range(WORLD):
            with open(self.logs[2 * rank], "w") as out, open(self.logs[2 * rank + 1], "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(TESTS, "torch_dp_worker.py"), str(rank),
                     str(WORLD), port, self.out, spec_path],
                    env=env, stdout=out, stderr=err))

    def load(self, name: str, rank: int) -> dict:
        """Rank ``rank``'s result of ``name``, waiting for it until the
        deadline; a case that raised fails with its traceback."""
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

    def _log(self, rank: int, stream: str) -> str:
        with open(self.logs[2 * rank + (stream == "err")]) as f:
            return f.read()

    def wait(self):
        """(exit code, standard output, standard error) of each worker, once
        both ended."""
        for p in self.procs:
            try:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                self.close()
                raise
        return [(p.returncode, self._log(rank, "out"), self._log(rank, "err"))
                for rank, p in enumerate(self.procs)]

    def stderr(self) -> str:
        self.close()
        return "\n".join(self._log(rank, "err")[-3000:] for rank in range(WORLD))

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    handle = _Workers(tmp_path_factory.mktemp("data_parallel"))
    yield handle
    handle.close()


def _jax_model(family):
    cls, config_cls = JAX_MODELS[family]
    return cls(config_cls(**cases.BASE, **FED[family][0]), seed=0)


def _assert_moves_close(ours: dict, ref: dict, start: dict, name: str):
    """Each tensor's move from ``start`` within ``MOVE_TOL`` of the
    reference move's norm."""
    assert set(ours) == set(ref)
    for k in ref:
        move = (ref[k] - start[k]).double()
        err = ((ours[k] - start[k]).double() - move).norm().item()
        assert err <= MOVE_TOL * move.norm().item() + 1e-9, (name, k, err)


# -------------------------------------------------------------- 14 families
@pytest.mark.parametrize("case", list(cases.CASES))
def test_two_ranks_equal_one_process_on_the_global_batch(workers, case, tmp_path):
    ref = cases.run_case(case, str(tmp_path), per_device_train_batch_size=2 * cases.PER_DEVICE,
                         per_device_eval_batch_size=2 * cases.PER_DEVICE)
    ranks = [workers.load(case, rank) for rank in range(WORLD)]
    assert ref["world"] == 1 and [r["world"] for r in ranks] == [WORLD, WORLD]
    for key in ("live", "best", "momentum"):
        if ranks[0][key] is None:
            assert ref[key] is None and ranks[1][key] is None, key
            continue
        for k, v in ranks[0][key].items():
            assert torch.equal(ranks[1][key][k], v), (key, k)   # replicas
        start = ref["start"] if key != "momentum" else {k: torch.zeros_like(v)
                                                        for k, v in ref[key].items()}
        _assert_moves_close(ranks[0][key], ref[key], start, key)
    for k, v in ref["start"].items():
        assert torch.equal(ranks[0]["start"][k], v), k
    assert len(ref["history"]) == cases.EPOCHS
    for ours, theirs, other in zip(ranks[0]["history"], ref["history"], ranks[1]["history"]):
        assert ours == other and set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **HISTORY_TOL)
    assert ranks[0]["lrs"] == ranks[1]["lrs"] == ref["lrs"]
    if case == "MVTCAE":   # the plateau cut once, from the global eval loss
        assert ref["lrs"] == [cases.LR / 2]


# ---------------------------------------------------------- the JAX trainer
@pytest.mark.parametrize("family", list(FED))
def test_two_ranks_equal_the_jax_trainer_on_two_devices(workers, family, tmp_path):
    fields, incomplete, with_eval, extra = FED[family]
    jmodel = _jax_model(family)
    start = state_of(jmodel.params)
    sets = [JDataset(data) if masks is None else JIncompleteDataset(data, masks)
            for data, masks in cases.arrays(incomplete, seed=1)]
    rec = Recorder()
    jtrainer = JTrainer(jmodel, sets[0], sets[1] if with_eval else None, callbacks=[rec],
                        training_config=JTrainerConfig(output_dir=str(tmp_path), n_devices=WORLD,
                                                       **COMMON, **extra))
    assert jtrainer.n_data_devices == WORLD
    jtrainer.train()
    ranks = [workers.load(f"jax_{family}", rank) for rank in range(WORLD)]
    # the converted weights, loaded from one file by each rank, are equal
    # before rank 0's broadcast
    assert ranks[0]["digest"] == ranks[1]["digest"] == cases.state_digest(
        _port_start(family, start))
    n_steps = COMMON["num_epochs"] * -(-cases.N_TRAIN // (WORLD * cases.PER_DEVICE))
    assert ranks[0]["steps"] == ranks[1]["steps"] == n_steps
    keys = ["train_epoch_loss"] + (["eval_epoch_loss"] if with_eval else [])
    for key in keys:
        ours = [h[key] for h in ranks[0]["history"]]
        assert ours == [h[key] for h in ranks[1]["history"]]
        np.testing.assert_allclose(ours, [h[key] for h in rec.logs], rtol=1e-4, err_msg=key)
    # the kept weights (the live ones where none were kept: no eval set)
    kept = ranks[0]["best"] if ranks[0]["best"] is not None else ranks[0]["live"]
    assert_same_moves(kept, state_of(jtrainer.best_params), start, COMMON["learning_rate"])
    for k, v in ranks[0]["live"].items():
        assert torch.equal(ranks[1]["live"][k], v), k


def _port_start(family, state):
    from multivae_tpu_torch import models

    model = getattr(models, family)(getattr(models, family + "Config")(
        **cases.BASE, **FED[family][0]), device="cpu")
    model.load_state_dict(state)
    return model


# ------------------------------------------------------------------ resume
def test_a_two_rank_resume_equals_the_uninterrupted_run(workers):
    """Rank 0 alone writes the checkpoints, the grids and the final model;
    both ranks resume from its ``checkpoint_epoch_2`` and give the
    uninterrupted run's third epoch and weights, bit for bit (the same CPU
    operations on the same numbers)."""
    ranks = [workers.load("resume", rank) for rank in range(WORLD)]
    for r in ranks:
        full, resumed = r["full"], r["resumed"]
        assert resumed["history"] == full["history"][2:]
        for key in ("live", "best"):
            for k, v in full[key].items():
                assert torch.equal(resumed[key][k], v), (key, k)
    assert ranks[0]["events"] == {"on_save": 1, "on_save_checkpoint": 3,
                                  "on_prediction_step": 3, "on_log": 3}
    assert ranks[1]["events"] == {"on_save": 0, "on_save_checkpoint": 0,
                                  "on_prediction_step": 0, "on_log": 3}
    assert ranks[0]["files"] == ranks[1]["files"]
    assert {"checkpoint_epoch_1", "checkpoint_epoch_2", "checkpoint_epoch_3",
            "final_model"} <= set(ranks[0]["files"])


def test_a_gradient_none_on_some_ranks_joins_as_zeros_and_none_on_all_stays_none(workers):
    """The reducer's presence mask: ``a`` (in both ranks' losses) sums,
    ``b`` (rank 0's only) comes out on both ranks as rank 0's gradient,
    ``c`` (in no loss) stays None, and the collective of ``a`` and ``b``
    stays in step."""
    ranks = [workers.load("reducer", rank) for rank in range(WORLD)]
    for r in ranks:
        a, b, c = r["grads"]
        assert torch.equal(a, torch.full((3,), 3.0))        # 1 + 2
        assert torch.equal(b, 2 * (torch.arange(3.0) + 1))  # d(b**2) on rank 0
        assert c is None
        assert r["bytes"] == 2 * 3 * 4


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("processes", [2, 4])
def test_loader_plans_match_the_jax_loader(processes, drop_last):
    """Each process's plan (the JAX loader's ``epoch_plan``: its columns of
    the global batch, the padding's zero weights) and the global plan, over
    three epochs of 37 rows in global batches of 16."""
    rng = np.random.default_rng(0)
    data = {"a": rng.normal(size=(37, 2)).astype(np.float32)}
    for rank in range(processes):
        kw = dict(batch_size=16, shuffle=True, seed=3, drop_last=drop_last,
                  num_processes=processes, process_index=rank)
        ours, theirs = DataLoader(MultimodalBaseDataset(data), **kw), JDataLoader(JDataset(data), **kw)
        assert ours.per_process_batch == theirs.per_process_batch == 16 // processes
        for epoch in range(3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for got, want in zip(ours.epoch_plan() + ours.global_epoch_plan(),
                                 theirs.epoch_plan() + theirs.global_epoch_plan()):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            batches = list(ours)
            assert len(batches) == len(theirs)
            np.testing.assert_array_equal(batches[-1].weights.numpy(), theirs.epoch_plan()[1][-1])


def test_chunked_columns_make_up_each_chunk_of_the_global_batch():
    """With ``chunks``, chunk c of every process's columns together is
    chunk c of the global batch, and each process's columns are a
    partition of it."""
    columns = [DataLoader(MultimodalBaseDataset({"a": np.zeros((40, 1), np.float32)}), 16,
                          num_processes=2, process_index=r, chunks=2).process_columns()
               for r in range(2)]
    np.testing.assert_array_equal(columns[0], [0, 1, 2, 3, 8, 9, 10, 11])
    np.testing.assert_array_equal(columns[1], [4, 5, 6, 7, 12, 13, 14, 15])
    for c in range(2):
        chunk = np.concatenate([cols[4 * c:4 * (c + 1)] for cols in columns])
        np.testing.assert_array_equal(chunk, np.arange(8 * c, 8 * (c + 1)))


# ----------------------------------------------------------- shard helpers
def test_data_shard_keeps_its_rows_of_global_draws():
    """Rank 1 of 2 keeps the rows [b, 2b) of a global draw along the named
    axis, of each block where the axis holds blocks; ``spread`` puts its
    rows there; one process changes nothing."""
    shard = DataShard(rank=1, world=2)
    full = torch.arange(3 * 2 * 8 * 5).reshape(3, 2 * 8, 5)

    def hook(shape, generator=None):
        assert tuple(shape) == (3, 16, 5)
        return full

    assert torch.equal(shard.draw(hook, (3, 8, 5), axis=-2), full[:, 8:])
    blocks = torch.arange(2 * 2 * 4).reshape(16, 1)   # 2 blocks of 8 global rows
    np.testing.assert_array_equal(shard.own(blocks, 0, blocks=2).ravel().numpy(),
                                  [4, 5, 6, 7, 12, 13, 14, 15])
    spread = shard.spread(torch.ones(4, 2))
    assert spread.shape == (8, 2) and spread[:4].sum() == 0 and spread[4:].sum() == 8
    np.testing.assert_array_equal(shard.rows(4).numpy(), [4, 5, 6, 7])
    assert shard.share(torch.tensor(3.0)).item() == 1.5
    alone = DataShard()
    assert alone.draw(lambda shape, g=None: torch.zeros(shape), (3, 8, 5)).shape == (3, 8, 5)


def test_a_mesh_alone_and_shard_batch():
    mesh = get_data_mesh(None, "cpu")
    assert (mesh.world_size, mesh.rank, mesh.distributed, mesh.is_main_process) == (1, 0, False, True)
    assert get_data_mesh(1, "cpu").world_size == 1
    batch = batch_from_arrays({"a": np.arange(8, dtype=np.float32)[:, None]})
    half = shard_batch(batch, type(mesh)(2, 1, 1, torch.device("cpu"), True))
    np.testing.assert_array_equal(half.data["a"].numpy().ravel(), [4, 5, 6, 7])
    assert half.weights.shape == (4,)


# ---------------------------------------------------------------- refusals
def test_refusals_under_the_group(workers, monkeypatch):
    """A ``n_devices`` the group does not match raises, naming the way out;
    ``steps_per_execution`` > 1 and the sharded cache layout are taken
    under two gloo ranks on the CPU. A gloo group on CUDA refuses
    ``steps_per_execution`` > 1, naming NCCL (its backend name patched in:
    there is no card here); an NCCL group, and gloo on the CPU, take it."""
    from types import SimpleNamespace

    from multivae_tpu_torch.parallel import DataMesh
    from multivae_tpu_torch.trainers import BaseTrainer

    messages = workers.load("refusals", 0)
    assert messages == workers.load("refusals", 1)
    assert messages["n_devices"].startswith("ValueError: n_devices=3 but the process group "
                                            "holds 2 processes")
    assert "one process per card" in messages["n_devices"]
    assert messages["steps_per_execution"] is None and messages["sharded"] is None

    graphed = BaseTrainerConfig(cache_on_device=True, steps_per_execution=2)
    backend = {}
    monkeypatch.setattr(DataMesh, "backend", property(lambda self: backend["name"]))
    for device, name, refused in (("cuda", "gloo", True), ("cuda", "nccl", False),
                                  ("cpu", "gloo", False)):
        backend["name"] = name
        trainer = SimpleNamespace(device=torch.device(device),
                                  mesh=DataMesh(2, 0, 0, torch.device(device), True))
        if refused:
            with pytest.raises(NotImplementedError, match="steps_per_execution > 1 under a "
                               "gloo process group on CUDA") as e:
                BaseTrainer._check_data_parallel(trainer, graphed)
            assert "NCCL" in str(e.value)
        else:
            BaseTrainer._check_data_parallel(trainer, graphed)
        BaseTrainer._check_data_parallel(trainer, BaseTrainerConfig())


def test_a_process_alone_opens_no_group(monkeypatch):
    """``maybe_init_distributed`` opens nothing without a coordinator and
    without torchrun's ``WORLD_SIZE`` above 1, nor for one process; the
    coordinator fields need this process's id. (No group is ever opened in
    the test process: later files' trainers would join it.)"""
    import torch.distributed as dist

    from multivae_tpu_torch.parallel import maybe_init_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not maybe_init_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not maybe_init_distributed(device="cpu")
    assert not maybe_init_distributed("127.0.0.1:1", num_processes=1, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        maybe_init_distributed("127.0.0.1:1", num_processes=2, device="cpu")
    assert not dist.is_initialized()


def test_n_devices_above_one_without_a_group_raises(tmp_path):
    with pytest.raises(ValueError, match="no process group exists.*one process per card"):
        cases.trainer_of("MVTCAE", str(tmp_path), n_devices=2)


def test_a_jax_training_config_with_the_parallel_fields_loads(tmp_path):
    """``n_devices``, ``coordinator_address``, ``num_processes``,
    ``process_id``, ``fsdp`` and ``n_model_devices`` of a JAX
    ``training_config.json`` load with their values, the file unedited.
    ``n_devices`` counts the data axis, as in the JAX package: with
    ``n_model_devices=2`` a trainer needs a group of ``n_devices x 2``
    processes, and in one process it raises naming both; with ``fsdp``
    alone one process builds a trainer whose state is cut (over a data axis
    of one)."""
    JTrainerConfig(output_dir="out", n_devices=4, coordinator_address="10.0.0.1:1234",
                   num_processes=2, process_id=1).save_json(str(tmp_path), "training_config")
    with open(tmp_path / "training_config.json") as f:
        saved = json.load(f)
    assert not set(saved) - set(BaseTrainerConfig().to_dict()) - {"name"}
    cfg = BaseTrainerConfig.from_json_file(str(tmp_path / "training_config.json"))
    assert (cfg.n_devices, cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (
        4, "10.0.0.1:1234", 2, 1)
    assert (cfg.n_model_devices, cfg.fsdp) == (1, False)
    JTrainerConfig(output_dir="out", n_devices=2, n_model_devices=2, fsdp=True).save_json(
        str(tmp_path / "2x2"), "training_config")
    both = BaseTrainerConfig.from_json_file(str(tmp_path / "2x2" / "training_config.json"))
    assert (both.n_devices, both.n_model_devices, both.fsdp) == (2, 2, True)
    with pytest.raises(ValueError, match="n_devices=2, n_model_devices=2 but no process group"):
        cases.trainer_of("MVTCAE", str(tmp_path / "run"), n_devices=2, n_model_devices=2,
                         fsdp=True)
    trainer = cases.trainer_of("MVTCAE", str(tmp_path / "run"), n_devices=1, fsdp=True)
    assert (trainer.mesh.n_data, trainer.mesh.n_model) == (1, 1)
    assert trainer._reducer is trainer._state and not trainer._state.active


def test_the_workers_end_cleanly(workers):
    """Both workers ran every case without an error and left the group."""
    for rc, out, err in workers.wait():
        assert rc == 0 and "DONE" in out, err[-3000:]
    assert not [f for f in os.listdir(workers.out) if f.endswith(".err")]
