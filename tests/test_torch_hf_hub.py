"""The port's Hugging Face hub paths and the trainer's file logger, on the
CPU with no network: ``huggingface_hub`` is monkeypatched with a fake hub
that stores what is pushed and serves it back (as the JAX package's
``tests/test_hf_hub.py`` does). A model pushed and loaded back gives the
same weights and the same outputs, exactly; one whose weights came from a
JAX model gives the JAX model's encode means (rtol 1e-5, atol 1e-6:
float32 matmuls in another order). ``train(log_output_dir=...)`` writes
the JAX trainer's lines, apart from the device line. The hub package is
imported only inside the hub functions."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.models import MVTCAE as JMVTCAE
from multivae_tpu.models import MVTCAEConfig as JMVTCAEConfig
from multivae_tpu.trainers import BaseTrainer as JTrainer
from multivae_tpu.trainers import BaseTrainerConfig as JTrainerConfig
from multivae_tpu_torch.data import MultimodalBaseDataset
from multivae_tpu_torch.models import MVTCAE, AutoModel, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig, MultistageTrainer
from torch_parity import port_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = {"m0": (4,), "m1": (5,)}


def tiny_model(seed=0, **kw):
    torch.manual_seed(seed)
    return MVTCAE(MVTCAEConfig(n_modalities=2, latent_dim=3, input_dims=DIMS), device="cpu",
                  **kw)


def _data(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return {m: rng.uniform(size=(n, *d)).astype(np.float32) for m, d in DIMS.items()}


class FakeHub:
    """Stands in for the HF hub: a push stores the files, a download serves
    them."""

    def __init__(self):
        self.repos = {}
        self.created_repos = []
        self.commits = []
        self.fail_first_commit = False

    def create_commit(self, commit_message, repo_id, operations):
        if self.fail_first_commit and repo_id not in self.repos:
            self.fail_first_commit = False
            raise RuntimeError("Repository Not Found")
        self.commits.append(commit_message)
        files = self.repos.setdefault(repo_id, {})
        for op in operations:
            with open(op.path_or_fileobj, "rb") as f:
                files[op.path_in_repo] = f.read()

    def create_repo(self, repo_id):
        self.created_repos.append(repo_id)
        self.repos.setdefault(repo_id, {})

    def hf_hub_download(self, repo_id, filename, local_dir):
        # serve from the first repo whose basename matches (create_repo
        # registers only the basename, as the real fallback path does)
        for rid, files in self.repos.items():
            if filename in files and (rid == repo_id
                                      or os.path.basename(rid) == os.path.basename(repo_id)):
                path = os.path.join(local_dir, filename)
                with open(path, "wb") as f:
                    f.write(files[filename])
                return path
        raise FileNotFoundError(f"{repo_id}/{filename}")


@pytest.fixture
def fake_hub(monkeypatch):
    import huggingface_hub

    hub = FakeHub()
    monkeypatch.setattr(huggingface_hub.HfApi, "create_commit",
                        lambda self, **kw: hub.create_commit(**kw))
    monkeypatch.setattr(huggingface_hub, "create_repo",
                        lambda repo_id: hub.create_repo(repo_id))
    monkeypatch.setattr(huggingface_hub, "hf_hub_download",
                        lambda repo_id, filename, local_dir:
                        hub.hf_hub_download(repo_id, filename, local_dir))
    return hub


def test_push_uploads_the_model_files_and_the_card(fake_hub):
    tiny_model().push_to_hf_hub("user/test-repo")
    files = fake_hub.repos["user/test-repo"]
    assert set(files) == {"model_config.json", "model.pt", "environment.json", "README.md"}
    assert json.loads(files["model_config.json"])["name"] == "MVTCAEConfig"
    card = files["README.md"].decode()
    assert "multivae_tpu_torch" in card and "load_from_hf_hub" in card
    assert fake_hub.commits == ["Uploading MVTCAE in user/test-repo"]


def test_push_creates_the_repo_when_the_first_commit_fails(fake_hub):
    fake_hub.fail_first_commit = True
    tiny_model().push_to_hf_hub("user/new-repo")
    assert fake_hub.created_repos == ["new-repo"]
    # the retry after create_repo pushed the files
    assert "model.pt" in fake_hub.repos["user/new-repo"]


def _outputs(model, data):
    with torch.no_grad():
        out = model.encode({m: torch.tensor(v) for m, v in data.items()}, return_mean=True)
    return out.z


def test_push_load_round_trip(fake_hub):
    model = tiny_model(seed=3)
    model.push_to_hf_hub("user/rt-repo")
    loaded = MVTCAE.load_from_hf_hub("user/rt-repo", device="cpu")
    assert loaded.model_config.latent_dim == 3 and loaded.device.type == "cpu"
    ref = model.state_dict()
    assert set(loaded.state_dict()) == set(ref)
    assert all(torch.equal(v, ref[k]) for k, v in loaded.state_dict().items())
    data = _data()
    assert torch.equal(_outputs(loaded, data), _outputs(model, data))


def test_automodel_dispatches_from_the_hub_config(fake_hub):
    tiny_model().push_to_hf_hub("user/auto-repo")
    loaded = AutoModel.load_from_hf_hub("user/auto-repo", device="cpu")
    assert type(loaded) is MVTCAE


def test_pickled_architectures_load_only_when_allowed(fake_hub):
    cfg = {m: BaseAEConfig(input_dim=d, latent_dim=3) for m, d in DIMS.items()}
    model = tiny_model(encoders={m: Encoder_VAE_MLP(c, hidden_dim=16) for m, c in cfg.items()},
                       decoders={m: Decoder_AE_MLP(c, hidden_dim=16) for m, c in cfg.items()})
    model.push_to_hf_hub("user/pickled-repo")
    assert {"encoders.pkl", "decoders.pkl"} <= set(fake_hub.repos["user/pickled-repo"])
    with pytest.raises(RuntimeError, match="allow_pickle"):
        MVTCAE.load_from_hf_hub("user/pickled-repo", device="cpu")
    with pytest.raises(RuntimeError, match="allow_pickle"):
        AutoModel.load_from_hf_hub("user/pickled-repo", device="cpu")
    loaded = AutoModel.load_from_hf_hub("user/pickled-repo", allow_pickle=True, device="cpu")
    data = _data()
    assert torch.equal(_outputs(loaded, data), _outputs(model, data))


def test_a_missing_hub_package_raises(monkeypatch):
    model = tiny_model()
    monkeypatch.setattr(type(model), "_hf_hub_is_available", staticmethod(lambda: False))
    with pytest.raises(ModuleNotFoundError, match="huggingface_hub"):
        model.push_to_hf_hub("user/x")
    with pytest.raises(ModuleNotFoundError, match="huggingface_hub"):
        MVTCAE.load_from_hf_hub("user/x")


def test_jax_weights_survive_the_round_trip(fake_hub):
    """Weights converted from a JAX model (``params_from_jax``), pushed and
    loaded back, give the JAX model's encode means."""
    kw = dict(n_modalities=2, latent_dim=3, input_dims=DIMS)
    jmodel = JMVTCAE(JMVTCAEConfig(**kw), seed=5)
    model = port_model(jmodel, MVTCAE(MVTCAEConfig(**kw), device="cpu"))
    model.push_to_hf_hub("user/from-jax")
    loaded = AutoModel.load_from_hf_hub("user/from-jax", device="cpu")
    data = _data(n=8, seed=2)
    ref = np.asarray(jmodel.encode(JDataset(data)[np.arange(8)], return_mean=True).z)
    np.testing.assert_allclose(_outputs(loaded, data).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_the_hub_package_is_imported_only_inside_the_hub_functions():
    for path in ("multivae_tpu_torch/models/base/base_model.py",
                 "multivae_tpu_torch/models/auto_model/auto_model.py"):
        with open(os.path.join(REPO, path)) as f:
            lines = [line for line in f if "huggingface_hub import" in line
                     or line.strip().startswith("import huggingface_hub")]
        assert lines and all(line.startswith("        ") for line in lines), (path, lines)
    code = ("import sys\nimport multivae_tpu_torch.models, multivae_tpu_torch.trainers\n"
            "import multivae_tpu_torch.data\n"
            "assert 'huggingface_hub' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ----------------------------------------------------------------- file logger
def _log_lines(log_dir):
    (name,) = os.listdir(log_dir)
    assert name.startswith("training_logs_") and name.endswith(".log")
    with open(os.path.join(log_dir, name)) as f:
        return name, f.read().splitlines()


def _training(trainer_kw):
    return dict(num_epochs=3, per_device_train_batch_size=4, per_device_eval_batch_size=4,
                learning_rate=1e-3, steps_saving=2, seed=0, **trainer_kw)


@pytest.mark.parametrize("multistage", [False, True])
def test_the_file_log_holds_the_jax_trainers_lines(tmp_path, multistage):
    kw = dict(n_modalities=2, latent_dim=3, input_dims=DIMS)
    jtrainer = JTrainer(JMVTCAE(JMVTCAEConfig(**kw), seed=0), JDataset(_data(10)),
                        JDataset(_data(4, seed=3)),
                        training_config=JTrainerConfig(output_dir=str(tmp_path / "jax_out"),
                                                       n_devices=1, **_training({})))
    jtrainer.train(log_output_dir=str(tmp_path / "jax_logs"))
    jname, jlines = _log_lines(tmp_path / "jax_logs")
    # the JAX trainer leaves its handler open: a port trainer started within
    # the same second gets the same logger name and would write there too
    jlogger = logging.getLogger(jname[:-len(".log")])
    for handler in list(jlogger.handlers):
        jlogger.removeHandler(handler)
        handler.close()
    cls = MultistageTrainer if multistage else BaseTrainer
    trainer = cls(MVTCAE(MVTCAEConfig(**kw), device="cpu"), MultimodalBaseDataset(_data(10)),
                  MultimodalBaseDataset(_data(4, seed=3)), device="cpu",
                  training_config=BaseTrainerConfig(output_dir=str(tmp_path / "out"),
                                                    **_training({})))
    trainer.train(log_output_dir=str(tmp_path / "logs"))
    name, lines = _log_lines(tmp_path / "logs")
    assert name == f"training_logs_{os.path.basename(trainer.training_dir)}.log"
    assert lines.count(" - device: cpu") == 1
    assert jlines.count(" - data-parallel devices: 1") == 1
    assert ([line for line in lines if line != " - device: cpu"]
            == [line for line in jlines if line != " - data-parallel devices: 1"])
    assert "Saved checkpoint at epoch 2" in lines and lines[0] == "Training params:"
    # the handler is closed: a second trainer of the process writes its own file
    trainer2 = cls(MVTCAE(MVTCAEConfig(**kw), device="cpu"), MultimodalBaseDataset(_data(10)),
                   device="cpu", training_config=BaseTrainerConfig(
                       output_dir=str(tmp_path / "out2"), **_training({})))
    trainer2.training_dir = trainer.training_dir   # the same log name on purpose
    trainer2.train(log_output_dir=str(tmp_path / "logs2"))
    assert _log_lines(tmp_path / "logs")[1] == lines
