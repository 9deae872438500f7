"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multivae_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pydantic", "cloudpickle",
             "multivae_tpu")
# `import x`, `import x.y`, `from x import`, `from x.y import`; the word
# boundary after the name keeps `multivae_tpu_torch` out of the match.
IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(" + "|".join(FORBIDDEN) + r")(?![\w])", re.M)


def _port_modules():
    mods = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_regex():
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert IMPORT_RE.search("from multivae_tpu.ops import kdist")
    assert IMPORT_RE.search("    from flax import linen")
    assert not IMPORT_RE.search("from multivae_tpu_torch.ops import kdist")
    assert not IMPORT_RE.search("import jaxtyping_like_name_is_fine")


@pytest.mark.parametrize("path", [
    os.path.relpath(os.path.join(root, f), REPO)
    for root, _, files in sorted(os.walk(PORT)) for f in sorted(files)
    if f.endswith(".py")
] + ["chip_smoke.py"])
def test_source_has_no_forbidden_import(path):
    with open(os.path.join(REPO, path)) as f:
        found = IMPORT_RE.findall(f.read())
    assert not found, f"{path} imports {found}"


def test_default_device_raises_without_cuda(monkeypatch):
    from multivae_tpu_torch.models import MMVAE, MMVAEConfig
    from multivae_tpu_torch.trainers import BaseTrainer
    from multivae_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MMVAEConfig(n_modalities=1, latent_dim=2, input_dims={"a": (3,)})
    with pytest.raises(RuntimeError, match="cuda"):
        MMVAE(cfg)
    model = MMVAE(MMVAEConfig(n_modalities=1, latent_dim=2,
                              input_dims={"a": (3,)}), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        BaseTrainer(model, None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


# (model, config, the config's extra fields, a workload that builds it)
DEVICE_CASES = {
    "mvtcae": ("MVTCAE", {}, None),
    "mmvaeplus": ("MMVAEPlus", {"modalities_specific_dim": 2}, "mmvaeplus_k10"),
    "cmvae": ("CMVAE", {"modalities_specific_dim": 2}, "cmvae_polymnist"),
    "mvae": ("MVAE", {}, "mvae_conv"),
    "mopoe": ("MoPoE", {}, "mopoe_conv"),
    "crmvae": ("CRMVAE", {}, "crmvae_resnet"),
    "dmvae": ("DMVAE", {"modalities_specific_dim": {"a": 1}}, "dmvae_mnist_svhn"),
    "jmvae": ("JMVAE", {}, "jmvae_conv"),
    "telbo": ("TELBO", {}, "telbo_conv"),
    "jnf": ("JNF", {}, "jnf_conv"),
    "nexus": ("Nexus", {"modalities_specific_dim": {"a": 2}}, "nexus_e2e"),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_model_default_device_raises_without_cuda(monkeypatch, case):
    from multivae_tpu_torch import models
    from multivae_tpu_torch.tools import workloads

    name, extra, workload = DEVICE_CASES[case]
    model_cls, config_cls = getattr(models, name), getattr(models, name + "Config")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(n_modalities=1, latent_dim=2, input_dims={"a": (3,)}, **extra)
    with pytest.raises(RuntimeError, match="cuda"):
        model_cls(config_cls(**cfg))
    if workload is not None:
        with pytest.raises(RuntimeError, match="cuda"):
            workloads.build(workload, n=8)
    assert model_cls(config_cls(**cfg), device="cpu").device == torch.device("cpu")


def test_cvae_and_multistage_trainer_default_to_cuda(monkeypatch):
    from multivae_tpu_torch.models import CVAE, TELBO, CVAEConfig, TELBOConfig
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import MultistageTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(main_modality="a", conditioning_modalities=["b"],
               input_dims={"a": (3,), "b": (2,)}, latent_dim=2)
    with pytest.raises(RuntimeError, match="cuda"):
        CVAE(CVAEConfig(**cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        workloads.build("cvae_tutorial", n=8)
    assert CVAE(CVAEConfig(**cfg), device="cpu").device == torch.device("cpu")
    telbo = TELBO(TELBOConfig(n_modalities=1, latent_dim=2, input_dims={"a": (3,)}),
                  device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        MultistageTrainer(telbo, None)


def test_mhvae_defaults_to_cuda(monkeypatch):
    from multivae_tpu_torch.models import MHVAE, MHVAEConfig
    from multivae_tpu_torch.tools import mhvae_nets, workloads

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = ("encoders", "decoders", "bottom_up_blocks", "top_down_blocks",
             "posterior_blocks", "prior_blocks")
    cfg = MHVAEConfig(n_modalities=1, latent_dim=2, input_dims={"a": (3, 28, 28)})
    blocks = dict(zip(names, mhvae_nets.build_blocks(["a"], 2, 2, 2, 4, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        MHVAE(cfg, **blocks)
    with pytest.raises(RuntimeError, match="cuda"):
        workloads.build("mhvae_polymnist", n=8)
    assert MHVAE(cfg, **blocks, device="cpu").device == torch.device("cpu")


def test_clustering_and_visualization_need_no_sklearn_or_pil(tmp_path):
    """The card's machine has neither scikit-learn nor Pillow: with both
    blocked, the latent clustering and the sample grids (PNGs written) run
    to their end."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import os, numpy as np, torch\n"
        "from multivae_tpu_torch.data import MultimodalBaseDataset\n"
        "from multivae_tpu_torch.metrics import (Clustering, ClusteringConfig,\n"
        "    Visualization, VisualizationConfig)\n"
        "from multivae_tpu_torch.models import MVTCAE, MVTCAEConfig\n"
        "rng = np.random.default_rng(0)\n"
        "dims = {'a': (3, 6, 6), 'b': (5,)}\n"
        "def ds(n):\n"
        "    return MultimodalBaseDataset({m: rng.uniform(size=(n, *d)).astype('float32')\n"
        "                                  for m, d in dims.items()},\n"
        "                                 labels=rng.integers(0, 3, n))\n"
        "model = MVTCAE(MVTCAEConfig(n_modalities=2, latent_dim=4, input_dims=dims),\n"
        "               device='cpu')\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "acc = Clustering(model, ds(20), ds(30), eval_config=ClusteringConfig(\n"
        "    n_clusters=3, number_of_runs=2, batch_size=8), generator=gen).eval()\n"
        "assert 0 <= acc.cluster_accuracy <= 1\n"
        f"out = {str(tmp_path)!r}\n"
        "vis = Visualization(model, ds(10), output=out, eval_config=VisualizationConfig(\n"
        "    n_samples=3, n_data_cond=2), generator=gen)\n"
        "assert vis.eval().unconditional_generation.dtype == np.uint8\n"
        "vis.conditional_samples_subset(['b'])\n"
        "assert sorted(os.listdir(out)) == [\"conditional_from_subset_['b'].png\",\n"
        "                                   'metrics.log', 'unconditional.png']\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in ('sklearn', 'PIL')\n"
        "            and sys.modules[k] is not None]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr
