"""The cases of ``test_torch_dp_eval_cache.py``, run by its two gloo worker
processes (``torch_dp_worker.py --cases torch_dp_eval_cases``) and, for the
one-process references, by the test process. Importing this module imports
no JAX; the jobs that feed the JAX package's draws import it inside.

- The chunked loop: MVAE and MMVAE of ``torch_dp_cases`` (three tiny
  modalities) on the device cache at ``steps_per_execution`` 1, 3 and 8.
- The row-sharded cache: the batches of two epochs from a replicated, a
  sharded and an "auto" cache (a budget only the sharded layout fits), and
  MVTCAE trained from each; a dataset rank 1 cannot index in bulk.
- The evaluators on MLP MVTCAE and MMVAE at three image modalities: every
  evaluator from the port's own generator, and the JAX package's draws fed
  call by call (``torch_parity.JaxCallDraws``) for the comparisons with the
  JAX evaluators at ``n_devices=2``; at ``n_devices=1`` under the group.
- MVAE's chunked run on the JAX cached trainer's draws (``mvae_fed_case``).
- JNF's HMC encode from a subset on each rank's rows (``jnf_encode``).
"""

import math
import os

import numpy as np
import torch
import torch.distributed as dist

import torch_dp_cases as cases
from multivae_tpu_torch.data import DataLoader, MultimodalBaseDataset
from multivae_tpu_torch.data.device_cache import (
    PlanBuffer,
    build_device_cache,
    cache_per_device_nbytes,
    estimate_dataset_nbytes,
)
from multivae_tpu_torch.metrics import (
    Clustering,
    ClusteringConfig,
    CoherenceEvaluator,
    CoherenceEvaluatorConfig,
    FIDEvaluator,
    FIDEvaluatorConfig,
    LikelihoodsEvaluator,
    LikelihoodsEvaluatorConfig,
    Reconstruction,
    ReconstructionConfig,
)
from multivae_tpu_torch.models import MMVAE, MVTCAE, MMVAEConfig, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig, Decoder_AE_MLP, Encoder_VAE_MLP
from multivae_tpu_torch.ops.kmeans import KMeans, kmeans_plusplus
from multivae_tpu_torch.parallel import get_data_mesh

WORLD = 2
CHUNKS = (1, 3, 8)
CHUNKED_FAMILIES = ("MVAE", "MMVAE")
LAYOUTS = ("replicated", "sharded", "auto")
PLAN_EPOCHS = (0, 1)

# the evaluators' world: 30 labelled rows of three image modalities (SSIM
# needs 11x11 at least) in batches of 12, so that the last batch's 6 real
# rows fall on rank 0 and its 6 padding rows on rank 1; 40 train rows for
# the clustering
DIMS = {"m0": (1, 12, 12), "m1": (3, 12, 12), "m2": (1, 12, 12)}
LATENT, HID, N_ROWS, N_TRAIN, BATCH, N_CLASSES = 6, 16, 30, 40, 12, 3
FAMILIES = ("mvtcae", "mmvae")
EVALUATORS = ("likelihoods", "coherence", "reconstruction", "fid", "clustering")
# (family, evaluator) compared with the JAX evaluator at n_devices=2: each
# evaluator once, MMVAE where the mixture draws its expert (the paper NLL
# through the mixture, the coherence's encode), MVTCAE elsewhere; the
# other pairs are held to one process above, and one process to JAX by
# test_torch_metrics.py
JAX_CASES = (("mmvae", "likelihoods"), ("mmvae", "coherence"), ("mvtcae", "reconstruction"),
             ("mvtcae", "fid"), ("mvtcae", "clustering"))
JAX_SEED = 3   # of the JAX model's key chain in each comparison


# ------------------------------------------------------------ the chunked loop
def chunked_case(family: str, n: int, outdir: str) -> dict:
    """``family`` of ``torch_dp_cases`` on the device cache at
    ``steps_per_execution`` ``n``, as this rank (or alone): its result."""
    trainer = cases.trainer_of(family, os.path.join(outdir, f"chunk_{family}_{n}"),
                               cache_on_device=True, steps_per_execution=n)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train()
    result = cases.result_of(trainer, start)
    cases.save(result, outdir, f"chunk_{family}_{n}")
    return result


# --------------------------------------------------------- the sharded cache
def _mesh():
    return get_data_mesh(None, "cpu")


def budget_of(layout: str, train, eval_set=None) -> int:
    """The device budget of ``layout``'s cases: ample, or for "auto" one
    that the replicated layout misses and the sharded one fits, for the
    train set and (with what the train block leaves) for the eval set."""
    if layout != "auto":
        return 10**9
    per_row = estimate_dataset_nbytes(train) // len(train)
    # under 37 rows' estimate, over half of it; what a train block of
    # ceil(37 / 2) = 19 rows takes on the device (its masks as float32)
    # leaves over half of the 21 eval rows' estimate, under all of it
    return 36 * per_row


def plan_batches(layout: str) -> dict:
    """Two epochs of the train set's batches (``torch_dp_cases``' MVTCAE data,
    incomplete, global batch 16) from a ``layout`` cache over the group, as
    this rank's columns: data, masks and weights as tensors."""
    train, _ = cases.datasets(True)
    mesh = _mesh()
    cache = build_device_cache(train, "cpu", budget_of(layout, train), layout=layout, mesh=mesh)
    loader = DataLoader(train, cases.PER_DEVICE * mesh.world_size, shuffle=True, seed=5,
                        num_processes=mesh.world_size, process_index=mesh.rank)
    plan = PlanBuffer(loader, "cpu", cache)
    batches = []
    for epoch in PLAN_EPOCHS:
        loader.set_epoch(epoch)
        idx, weights = plan.upload()
        for i in range(len(idx)):
            b = cache.gather(idx[i], weights[i], plan.columns)
            batches.append({"data": {m: t.clone() for m, t in b.data.items()},
                            "masks": {m: t.clone() for m, t in b.masks.items()},
                            "weights": b.weights.clone()})
    return dict(kind=type(cache).__name__, nbytes=cache_per_device_nbytes(cache),
                batches=batches)


def layout_case(layout: str, outdir: str) -> dict:
    """MVTCAE of ``torch_dp_cases`` trained from a ``layout`` cache (with
    the eval set), as this rank: its result, the caches' kinds and bytes,
    and the batches of ``plan_batches``."""
    train, eval_set = cases.datasets(True)
    trainer = cases.trainer_of(
        "MVTCAE", os.path.join(outdir, f"layout_{layout}"), cache_on_device=True,
        device_cache_layout=layout,
        device_cache_budget_gb=budget_of(layout, train, eval_set) / 1e9)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train()
    result = dict(cases.result_of(trainer, start), **plan_batches(layout),
                  caches={w: (type(c).__name__, cache_per_device_nbytes(c)) for w, c in (
                      ("train", trainer._train_cache), ("eval", trainer._eval_cache))})
    cases.save(result, outdir, f"layout_{layout}")
    return result


class _FailsOnRank1(MultimodalBaseDataset):
    """A dataset whose bulk ``get_batch`` fails on rank 1 (one row reads)."""

    def get_batch(self, index):
        if dist.get_rank() == 1 and len(np.atleast_1d(index)) > 1:
            raise IndexError("no bulk indexing here")
        return super().get_batch(index)


def fallback_case(outdir: str) -> dict:
    """A "sharded" and a "replicated" cache of a dataset that rank 1 cannot
    index in bulk, as this rank: each cache's kind (None: the host loader),
    and that a collective still meets after them."""
    (data, _), _ = cases.arrays(False)
    ds = _FailsOnRank1(data)
    result = {}
    for layout in ("sharded", "replicated"):
        cache = build_device_cache(ds, "cpu", 10**9, layout=layout, mesh=_mesh())
        result[layout] = None if cache is None else type(cache).__name__
    dist.barrier()
    cases.save(result, outdir, "fallback")
    return result


# ------------------------------------------------------------- the evaluators
def eval_arrays():
    """The evaluators' data: (test data, test labels, train data, train
    labels, the classifiers' weights)."""
    rng = np.random.default_rng(0)
    data = {m: rng.uniform(size=(N_ROWS, *d)).astype(np.float32) for m, d in DIMS.items()}
    labels = rng.integers(0, N_CLASSES, N_ROWS)
    train = {m: rng.uniform(size=(N_TRAIN, *d)).astype(np.float32) for m, d in DIMS.items()}
    train_labels = rng.integers(0, N_CLASSES, N_TRAIN)
    weights = {m: (rng.normal(size=(math.prod(d), N_CLASSES)) * 0.5).astype(np.float32)
               for m, d in DIMS.items()}
    return data, labels, train, train_labels, weights


def model_kwargs(family: str) -> dict:
    """The config fields of ``family`` (the JAX model takes the same)."""
    common = dict(n_modalities=len(DIMS), latent_dim=LATENT, input_dims=DIMS,
                  decoders_dist={m: "laplace" for m in DIMS})
    if family == "mmvae":
        return dict(common, K=3, prior_and_posterior_dist="laplace_with_softmax")
    return common


def port_model(family: str, state: dict):
    """The port's MLP ``family`` with the weights ``state``."""
    enc = {m: Encoder_VAE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
           for m, d in DIMS.items()}
    dec = {m: Decoder_AE_MLP(BaseAEConfig(input_dim=d, latent_dim=LATENT), hidden_dim=HID)
           for m, d in DIMS.items()}
    cls, config = (MMVAE, MMVAEConfig) if family == "mmvae" else (MVTCAE, MVTCAEConfig)
    model = cls(config(**model_kwargs(family)), enc, dec, device="cpu")
    model.load_state_dict(state)
    return model


def classifiers(weights: dict) -> dict:
    return {m: (lambda x, w=torch.tensor(w): x.flatten(1) @ w) for m, w in weights.items()}


def kmeans_init(model, train: dict) -> torch.Tensor:
    """k-means++ centres of the train rows' posterior means, from a seeded
    generator: the JAX and the port clusterings start from them."""
    with torch.no_grad():
        z = model.encode(MultimodalBaseDataset(train), return_mean=True).z
    return kmeans_plusplus(z, N_CLASSES, torch.Generator().manual_seed(2))


def evaluator_call(family: str, evaluator: str, model, n_devices: int, generator=None):
    """The port's ``evaluator`` on ``model`` at ``n_devices``: a call that
    returns its metrics. Likelihoods: 5 samples in chunks of 2 (MMVAE's
    paper estimator, one value a row); coherence: 26 joint samples, 2 draws
    a row; reconstruction: SSIM for MVTCAE, MSE for MMVAE; FID: every
    subset of the others to ``m0``, embedded by the classifiers' logits;
    clustering: 2 runs from ``kmeans_init``."""
    data, labels, train, train_labels, weights = eval_arrays()
    ds = MultimodalBaseDataset(data, labels=labels)
    common = dict(batch_size=BATCH, n_devices=n_devices)
    if evaluator == "likelihoods":
        ev = LikelihoodsEvaluator(model, ds, generator=generator,
                                  eval_config=LikelihoodsEvaluatorConfig(
                                      num_samples=5, batch_size_k=2,
                                      unified_implementation=family == "mvtcae", **common))
        return ev.eval
    if evaluator == "coherence":
        ev = CoherenceEvaluator(model, classifiers(weights), ds, generator=generator,
                                eval_config=CoherenceEvaluatorConfig(
                                    num_classes=N_CLASSES, nb_samples_for_joint=26,
                                    nb_samples_for_cross=2, **common))
        return ev.eval
    if evaluator == "reconstruction":
        metric = "SSIM" if family == "mvtcae" else "MSE"
        ev = Reconstruction(model, ds, generator=generator,
                            eval_config=ReconstructionConfig(metric=metric, **common))
        return ev.eval
    if evaluator == "fid":
        ev = FIDEvaluator(model, ds, custom_encoders=classifiers(weights), generator=generator,
                          eval_config=FIDEvaluatorConfig(**common))
        return lambda: ev.compute_all_conditional_fids("m0")
    ev = Clustering(model, ds, MultimodalBaseDataset(train, labels=train_labels),
                    generator=generator,
                    eval_config=ClusteringConfig(n_clusters=N_CLASSES, number_of_runs=2,
                                                 **common))
    ev.clustering = KMeans(N_CLASSES, init=kmeans_init(model, train))
    return ev.eval


def port_metrics(family: str, evaluator: str, state: dict, n_devices: int) -> dict:
    """``evaluator``'s metrics on the port's ``family``, from a seeded
    generator."""
    model = port_model(family, state)
    call = evaluator_call(family, evaluator, model, n_devices,
                          generator=torch.Generator().manual_seed(4))
    return {k: float(v) for k, v in call().items()}


def eval_case(states: dict, outdir: str) -> dict:
    """Every evaluator on both families at ``n_devices`` = the group's size,
    from the port's generator, as this rank."""
    world = dist.get_world_size()
    result = {(f, e): port_metrics(f, e, states[f], world)
              for f in FAMILIES for e in EVALUATORS}
    cases.save(result, outdir, "evaluators")
    return result


def alone_case(states: dict, outdir: str) -> dict:
    """Every evaluator on MVTCAE at ``n_devices=1`` under the group, and a
    ``Reconstruction`` at its default config, as this rank: each evaluates
    alone."""
    result = {e: port_metrics("mvtcae", e, states["mvtcae"], 1) for e in EVALUATORS}
    result["default"] = default_reconstruction(states["mvtcae"])
    cases.save(result, outdir, "alone")
    return result


def default_reconstruction(state: dict) -> dict:
    """``Reconstruction`` of the port's MLP MVTCAE with no config given,
    from a seeded generator."""
    data, labels, *_ = eval_arrays()
    ev = Reconstruction(port_model("mvtcae", state), MultimodalBaseDataset(data, labels=labels),
                        generator=torch.Generator().manual_seed(4))
    return {k: float(v) for k, v in ev.eval().items()}


def _jax():
    """JAX, on the CPU (only its draws are used here)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_keys(n: int):
    """The JAX model's first ``n`` keys after ``set_seed(JAX_SEED)``
    (``next_rng`` splits its key each call)."""
    jax = _jax()
    rng, keys = jax.random.key(JAX_SEED), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return keys


def fed_metrics(family: str, evaluator: str, state: dict, n_devices: int) -> dict:
    """``evaluator``'s metrics on the port's ``family`` fed the JAX model's
    draws call by call (imports JAX)."""
    _jax()
    from torch_parity import JaxCallDraws

    model = port_model(family, state)
    JaxCallDraws(model, jax_keys(64), mixture=family == "mmvae")
    return {k: float(v) for k, v in evaluator_call(family, evaluator, model, n_devices)().items()}


def fed_case(states: dict, outdir: str) -> dict:
    world = dist.get_world_size()
    result = {(f, e): fed_metrics(f, e, states[f], world) for f, e in JAX_CASES}
    cases.save(result, outdir, "fed")
    return result


# ------------------------------------------------- JNF's HMC encode
JNF_ROWS = 16


def jnf_encode(shard=None) -> torch.Tensor:
    """JNF of ``torch_dp_cases`` encoding the first ``JNF_ROWS`` train rows
    from two of its three modalities (the HMC path, 2 draws a row, 3 steps
    of 2 leapfrogs) from a seeded generator: alone on every row, or with
    ``shard`` (a ``DataShard``) on this rank's rows only."""
    from multivae_tpu_torch.data import as_batch
    from multivae_tpu_torch.parallel import DataMesh, shard_batch

    model = cases.model_of("JNF")
    train, _ = cases.datasets(False)
    batch = as_batch(train[np.arange(JNF_ROWS)])
    if shard is not None:
        batch = shard_batch(batch, DataMesh(shard.world, shard.rank, shard.rank,
                                            torch.device("cpu"), True))
    with torch.no_grad(), model.sharded(shard):
        return model.encode(batch, cond_mod=["a", "b"], N=2, mcmc_steps=3, n_lf=2,
                            generator=torch.Generator().manual_seed(6)).z


def jnf_case(outdir: str) -> dict:
    from multivae_tpu_torch.parallel import DataShard

    result = {"z": jnf_encode(DataShard(dist.get_rank(), dist.get_world_size(), True))}
    cases.save(result, outdir, "jnf_encode")
    return result


# ------------------------------------------ the chunked loop against JAX
# the JAX cached trainer's settings (its chunked path at n_devices=2)
MVAE_FED = dict(num_epochs=2, learning_rate=1e-3, per_device_train_batch_size=cases.PER_DEVICE,
                per_device_eval_batch_size=cases.PER_DEVICE, seed=7, optimizer_cls="Adam",
                cache_on_device=True, steps_per_execution=3, pipeline_epochs=False)


def mvae_fed_case(state: dict, outdir: str) -> dict:
    """MVAE of ``torch_dp_cases`` (k=1) with the JAX model's initial
    weights, trained chunked as this rank on the JAX trainer's draws (its
    noise per subset and its random subsets, from the step's key; imports
    JAX)."""
    jax = _jax()
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
    from torch_parity import feed_trainer_noise, normal

    model = cases.model_of("MVAE")
    model.load_state_dict(state)
    train, eval_set = cases.datasets(True, seed=1)
    trainer = BaseTrainer(model, train, eval_set, device="cpu",
                          training_config=BaseTrainerConfig(
                              output_dir=os.path.join(outdir, "mvae_fed"), **MVAE_FED))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    current = {}

    def draws_of_key(key):
        # the JAX MVAE's loss: split(key, 2 + M + k), a normal draw a
        # subset, the k random subsets from the first key's second split
        rng, *subs = jax.random.split(key, 2 + len(cases.DIMS) + 1)
        current["choice"] = jax.random.split(rng)[1]
        return lambda shape, generator=None: torch.stack(
            [normal(k, shape[1:]) for k in subs[:shape[0]]])

    model.draw_subsets = lambda n, k, generator=None: torch.tensor(np.asarray(
        jax.random.choice(current["choice"], n, shape=(k,), replace=False)))
    steps = feed_trainer_noise(trainer, model, draws_of_key, MVAE_FED["seed"])
    trainer.train()
    result = dict(cases.result_of(trainer, start), steps=next(steps))
    cases.save(result, outdir, "mvae_fed")
    return result


# -------------------------------------------------------------------- jobs
def jobs(outdir: str, port: str, world: int, rank: int, spec: str):
    """The worker's jobs, in order, once it joined the gloo group at
    ``127.0.0.1:port``; ``spec`` is the file of the JAX models' weights,
    which the test process writes while the first jobs run."""
    import datetime
    import time

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    loaded = {}

    def states():
        if not loaded:
            deadline = time.monotonic() + 120
            while not os.path.exists(spec) and time.monotonic() < deadline:
                time.sleep(0.05)
            loaded.update(torch.load(spec, weights_only=True))
        return loaded

    out = [(f"chunk_{f}_{n}", lambda f=f, n=n: chunked_case(f, n, outdir))
           for f in CHUNKED_FAMILIES for n in CHUNKS]
    out += [("jnf_encode", lambda: jnf_case(outdir)),
            ("mvae_fed", lambda: mvae_fed_case(states()["mvae"], outdir))]
    out += [(f"layout_{layout}", lambda layout=layout: layout_case(layout, outdir))
            for layout in LAYOUTS]
    out += [("fallback", lambda: fallback_case(outdir)),
            ("alone", lambda: alone_case(states(), outdir)),
            ("evaluators", lambda: eval_case(states(), outdir)),
            ("fed", lambda: fed_case(states(), outdir))]
    return out
