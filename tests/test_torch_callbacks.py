"""The port's training callbacks and prediction grids against the JAX
package's, on the CPU at a small size: MVTCAE on the MLP nets (two image
modalities of 1x5x5 and 3x4x4 and a vector, latent 8, hidden 16), 20 train
rows in batches of 8 and a 12-row eval set, 2 epochs with a checkpoint and
the grids every epoch.

Compared: the events a callback sees, in order and with their keyword
arguments; ``StepTimingCallback``'s keys; ``rename_logs``; ``WandbCallback``
against a stub ``wandb``; the default callbacks with ``tqdm`` blocked;
``TorchProfilerCallback``'s trace; and ``predict()``'s grids against the
JAX trainer's PIL images, pixel by pixel within one level (the decoders'
outputs agree to float32 noise, and a value near a rounding boundary of
the 8-bit levels may fall on either side), each encode fed the draw of
the key the JAX model handed to the same call.
"""

import importlib.machinery
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.nn import BaseAEConfig as JAEConfig
from multivae_tpu.nn import Decoder_AE_MLP as JDecoder
from multivae_tpu.nn import Encoder_VAE_MLP as JEncoder
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu.trainers.base import callbacks as jcallbacks
from multivae_tpu_torch.data import MultimodalBaseDataset
from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.trainers.base import callbacks
from test_torch_cvae import _arrays as cvae_arrays
from test_torch_cvae import _models as cvae_models
from torch_parity import normal, port_model, record_keys

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = {"m0": (1, 5, 5), "m1": (3, 4, 4), "m2": (6,)}
LATENT, HID, B, SEED = 8, 16, 8, 11
COMMON = dict(num_epochs=2, learning_rate=1e-3, per_device_train_batch_size=B,
              per_device_eval_batch_size=B, seed=SEED, steps_saving=1, steps_predict=1)


def _models():
    kw = dict(n_modalities=3, latent_dim=LATENT, input_dims=DIMS,
              decoders_dist={m: "normal" for m in DIMS}, alpha=0.3, beta=2.5)
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


def _arrays(seed, n):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


DATA, EVAL = _arrays(4, 20), _arrays(5, 12)


def _events(base):
    """A callback of ``base`` that logs (event, sorted keyword names)."""

    class Events(base):
        def __init__(self):
            self.log = []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                log = object.__getattribute__(self, "log")
                return lambda training_config, **kwargs: log.append((name, sorted(kwargs)))
            return object.__getattribute__(self, name)

    return Events()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers, 2 epochs, each with an event recorder and
    ``StepTimingCallback``. The JAX trainer runs its synchronous loop
    (``pipeline_epochs=False``): the port has no other."""
    tmp = tmp_path_factory.mktemp("callbacks")
    jmodel, tmodel = _models()
    jevents, jtiming = _events(jcallbacks.TrainingCallback), jcallbacks.StepTimingCallback()
    jtrainer = JTrainer(jmodel, JDataset(DATA), JDataset(EVAL), callbacks=[jevents, jtiming],
                        training_config=JTrainerConfig(output_dir=str(tmp / "jax"),
                                                       n_devices=1, pipeline_epochs=False,
                                                       **COMMON))
    jtrainer.train()
    events, timing = _events(callbacks.TrainingCallback), callbacks.StepTimingCallback()
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(DATA), MultimodalBaseDataset(EVAL),
                          callbacks=[events, timing], device="cpu",
                          training_config=BaseTrainerConfig(output_dir=str(tmp / "torch"),
                                                            **COMMON))
    trainer.train()
    return dict(jtrainer=jtrainer, jevents=jevents, jtiming=jtiming, trainer=trainer,
                events=events, timing=timing)


def test_events_and_their_keywords_match_jax(runs):
    ours, ref = runs["events"].log, runs["jevents"].log
    assert ours == ref
    names = [e for e, _ in ours]
    assert names.count("on_train_step_end") == 2 * 3 and names.count("on_eval_step_end") == 4
    assert names.count("on_save_checkpoint") == names.count("on_prediction_step") == 2
    assert names[:3] == ["on_init_end", "on_train_begin", "on_epoch_begin"]
    assert names[-2:] == ["on_save", "on_train_end"]
    assert dict(ours)["on_log"] == ["global_step", "logger", "logs", "model"]


def test_step_timing_keys_match_jax(runs):
    timing, jtiming = runs["timing"], runs["jtiming"]
    assert [sorted(h) for h in timing.history] == [sorted(h) for h in jtiming.history] == [
        ["epoch_time_s", "steps"]] * 2
    assert [h["steps"] for h in timing.history] == [h["steps"] for h in jtiming.history] == [3, 3]
    for h in runs["trainer"].history:
        assert {"epoch_time_s", "train_steps_per_s"} <= set(h)
        assert h["train_steps_per_s"] > 0


def test_grid_files_are_the_ones_the_jax_trainer_writes(runs):
    def pngs(trainer):
        return sorted(f for f in os.listdir(trainer.training_dir) if f.endswith(".png"))

    assert pngs(runs["trainer"]) == pngs(runs["jtrainer"]) == [
        "recon_from_all.png", "recon_from_m0.png", "recon_from_m1.png", "recon_from_m2.png"]
    with open(os.path.join(runs["trainer"].training_dir, "recon_from_all.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_rename_logs_matches_jax():
    logs = {"train_loss": 1.0, "eval_loss": 2.0, "other": 3.0, "train_eval_x": 4.0}
    assert callbacks.rename_logs(logs) == jcallbacks.rename_logs(logs) == {
        "train/loss": 1.0, "eval/loss": 2.0, "train/eval_x": 4.0}


class _StubRun:
    def __init__(self, **kw):
        self.kw, self.updates, self.finished = kw, [], False
        self.config = self
        self.entity, self.project, self.id = "ent", "proj", "run7"

    def update(self, d):
        self.updates.append(d)

    def finish(self):
        self.finished = True


@pytest.fixture
def stub_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.__spec__ = importlib.machinery.ModuleSpec("wandb", loader=None)
    mod.runs, mod.logged = [], []

    def init(**kw):
        mod.runs.append(_StubRun(**kw))
        return mod.runs[-1]

    mod.init = init
    mod.log = mod.logged.append
    mod.Image = lambda array: ("image", np.asarray(array).shape)
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def test_wandb_callback_against_a_stub(stub_wandb, tmp_path):
    """Setup (and the resume path's run id), the renamed epoch logs, the
    grids as images, the run path beside each checkpoint, the finish."""
    assert callbacks.wandb_is_available()
    cb = callbacks.WandbCallback()
    cfg = BaseTrainerConfig(output_dir=str(tmp_path), num_epochs=1)
    cb.setup(cfg, project_name="proj", entity_name="ent")
    assert stub_wandb.runs[-1].kw == {"project": "proj", "entity": "ent"}
    resumed = callbacks.WandbCallback()
    resumed.setup(cfg, run_id="abc123")
    assert stub_wandb.runs[-1].kw["id"] == "abc123"
    assert stub_wandb.runs[-1].kw["resume"] == "must"

    _, tmodel = _models()
    wandb_cb = callbacks.WandbCallback()
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(DATA), MultimodalBaseDataset(EVAL),
                          callbacks=[wandb_cb], device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path), **dict(COMMON, num_epochs=1)))
    trainer.train()
    run = stub_wandb.runs[-1]
    assert run.finished and any("training_config" in u for u in run.updates)
    assert any("model_config" in u for u in run.updates)
    images, logs = stub_wandb.logged[-2:]
    assert set(images) == {"recon_from_m0", "recon_from_m1", "recon_from_m2",
                           "recon_from_all", "train/global_step"}
    assert images["recon_from_all"][0] == "image" and images["recon_from_all"][1][2] == 3
    assert logs["train/global_step"] == 1
    assert logs["train/epoch_loss"] == trainer.history[0]["train_epoch_loss"]
    assert logs["eval/epoch_loss"] == trainer.history[0]["eval_epoch_loss"]
    checkpoint = os.path.join(trainer.training_dir, "checkpoint_epoch_1")
    assert callbacks.load_wandb_path_from_folder(checkpoint) == "ent/proj/run7"


def test_default_callbacks_run_without_tqdm(tmp_path):
    """The card's machine has no tqdm: with it blocked, the trainer (which
    always appends the progress bar) trains, draws no bar and raises
    nothing."""
    code = (
        "import sys\n"
        "sys.modules['tqdm'] = None\n"
        "import numpy as np\n"
        "from multivae_tpu_torch.data import MultimodalBaseDataset\n"
        "from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig\n"
        "from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig\n"
        "from multivae_tpu_torch.trainers.base.callbacks import ProgressBarCallback\n"
        "rng = np.random.default_rng(0)\n"
        "ds = MultimodalBaseDataset({'a': rng.uniform(size=(12, 3)).astype('float32'),\n"
        "                            'b': rng.uniform(size=(12, 4)).astype('float32')})\n"
        "model = MVTCAE(MVTCAEConfig(n_modalities=2, latent_dim=2,\n"
        "                            input_dims={'a': (3,), 'b': (4,)}), device='cpu')\n"
        f"cfg = BaseTrainerConfig(output_dir={str(tmp_path)!r}, num_epochs=1,\n"
        "                        per_device_train_batch_size=4, per_device_eval_batch_size=4)\n"
        "trainer = BaseTrainer(model, ds, ds, training_config=cfg, device='cpu')\n"
        "trainer.train()\n"
        "bars = [cb for cb in trainer.callback_handler.callbacks\n"
        "        if isinstance(cb, ProgressBarCallback)]\n"
        "assert len(bars) == 1 and bars[0].train_progress_bar is None\n"
        "assert bars[0].eval_progress_bar is None\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'tqdm'\n"
        "            and sys.modules[k] is not None]\n"
        "print('ok', len(trainer.history))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok 1" in proc.stdout, proc.stdout + proc.stderr


def test_torch_profiler_callback_writes_a_trace(tmp_path):
    _, tmodel = _models()
    trace_dir = tmp_path / "traces"
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(DATA), device="cpu",
                          callbacks=[callbacks.TorchProfilerCallback(str(trace_dir),
                                                                     epochs=(2,))],
                          training_config=BaseTrainerConfig(
                              output_dir=str(tmp_path / "out"), num_epochs=2,
                              per_device_train_batch_size=B))
    trainer.train()
    assert os.listdir(trace_dir) == ["trace_epoch_2.json"]
    with open(trace_dir / "trace_epoch_2.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("family", ["mvtcae", "cvae"])
def test_predict_grids_match_jax(tmp_path, family):
    """The grids of an untrained trainer (the live weights, equal in both)
    on the eval set's first 8 rows: from each modality and from all for a
    ``BaseMultiVAE``, the main modality from all for CVAE."""
    if family == "mvtcae":
        (jmodel, tmodel), data, eval_data = _models(), DATA, EVAL
    else:
        (jmodel, tmodel), data, eval_data = cvae_models(), cvae_arrays(1, 16), cvae_arrays(2, 12)
    jtrainer = JTrainer(jmodel, JDataset(data), JDataset(eval_data),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax"),
                                                       n_devices=1))
    trainer = BaseTrainer(tmodel, MultimodalBaseDataset(data), MultimodalBaseDataset(eval_data),
                          device="cpu",
                          training_config=BaseTrainerConfig(output_dir=str(tmp_path / "t")))
    keys = record_keys(jmodel)
    ref = {k: np.asarray(v) for k, v in jtrainer.predict().items()}
    # one encode a grid, each drawing its noise from the key the JAX model
    # handed to the same call
    assert len(keys) == len(ref)
    tmodel.draw_noise = lambda shape, generator=None: normal(keys.pop(0), shape)
    grids = trainer.predict()
    assert not keys
    assert set(grids) == set(ref) == ({"m0", "m1", "m2", "all"} if family == "mvtcae"
                                      else {"all"})
    for k, ref_grid in ref.items():
        assert grids[k].dtype == np.uint8 and grids[k].shape == ref_grid.shape, k
        diff = np.abs(grids[k].astype(int) - ref_grid.astype(int))
        assert diff.max() <= 1, k
        assert (diff == 0).mean() > 0.99, k
