"""The cases of ``test_torch_state_sharding.py``, run by its gloo worker
processes (``torch_dp_worker.py --cases torch_state_sharding_cases``): a
group of two ranks and a group of four, started together; and, for the
one-process references, by the test process. Importing this module imports
no JAX.

Two ranks (data 2, or data 1 x model 2):

- ``optimizers``: MVTCAE of ``torch_dp_cases`` (three tiny modalities,
  default nets) trained with ``fsdp`` off and on under every optimizer of
  ``OPTIMIZERS``: the histories, whole weights and whole optimizer states,
  and each run's bytes at rest.
- ``fsdp_conv`` / ``tp_conv``: ``conv_mmvae`` (two PolyMNIST-shaped
  modalities, the conv nets, DReG) with ``fsdp`` over data 2, and over
  data 1 x model 2 (every conv and dense layer of 64 output channels or
  more computes its own columns).
- ``tp_mvtcae``: the JAX ``test_tp_loss_matches_single_device`` model (two
  modalities of 2 and 3 features, latent 4) over model 2, with rank 0's
  prediction grids (whole weights, plain forwards, on rank 0 alone).
- ``fsdp_bf16``: MVTCAE's ``mixed_precision`` run, replicated and with
  ``fsdp``, and the masters' and moments' dtypes.
- ``fsdp_checkpoint``: MVTCAE under ``fsdp`` for 3 epochs with a checkpoint
  and the grids each epoch, and resumed from epoch 2's under ``fsdp`` (the test also
  resumes it in one process).
- ``fsdp_orbax``: the same with ``checkpoint_backend="orbax"``: each rank
  writes its pieces of every epoch's train state in the background, and the
  two ranks resume from epoch 2's (the test restores epoch 3's in one
  process, replicated and with ``fsdp``).
- ``fsdp_chunked``: MMVAE on the device cache under ``fsdp``, step by step
  and at ``steps_per_execution`` 3.
- ``fsdp_telbo``: TELBO through the ``MultistageTrainer`` (an optimizer
  reset and frozen groups in stage 2), replicated and with ``fsdp``.
- ``fsdp_microbatch``: MMVAE at ``microbatch_steps=2``, replicated and
  with ``fsdp``.
- ``fsdp_export``: MVTCAE with ``fsdp``; an endpoint's export at the end of
  epoch 1 (the modules hold the masters) must raise, and after ``train()``
  rank 0 exports a deterministic ``Predictor``.
- ``cub_fsdp``: ``cub_mvtcae`` (MVTCAE on narrow CUB nets: the text
  encoder's per-head attention projections, reshaped JAX leaves) replicated
  and with ``fsdp`` over data 2, the latter saving its train state sharded
  (``"orbax"``) at its end.
- ``cub_tp``: ``cub_mvtcae`` over data 1 x model 2.

Four ranks (data 2 x model 2):

- ``both``: the JAX ``test_tp_composes_with_fsdp`` model (latent 8) with
  ``fsdp``.
- ``cache_2x2``: the ``"sharded"`` device cache: each rank's block, its
  batches of one epoch, and MVTCAE trained from it with ``fsdp``.
- ``orbax_2x2``: ``fsdp_orbax``'s epoch 3 restored with ``fsdp``: the whole
  weights and optimizer state right after the restore, then one epoch,
  saved sharded in this layout (the test restores it in one process).
- ``cub_2x2``: ``cub_fsdp``'s checkpoint restored with ``fsdp`` on data 2 x
  model 2: the whole weights and optimizer state right after the restore.
"""

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

import torch_dp_cases as cases
from multivae_tpu_torch.data import MultimodalBaseDataset
from multivae_tpu_torch.models import MMVAE, MVTCAE, MMVAEConfig, MVTCAEConfig
from multivae_tpu_torch.nn import BaseAEConfig
from multivae_tpu_torch.nn.cub import (
    CUB_Resnet_Decoder,
    CUB_Resnet_Encoder,
    CubTextDecoderMLP,
    CubTextEncoder,
)
from multivae_tpu_torch.nn.mmnist import DecoderConvMMNIST, EncoderConvMMNIST_adapted
from multivae_tpu_torch.parallel.state import state_nbytes
from multivae_tpu_torch.serving import Predictor
from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig
from multivae_tpu_torch.trainers.base.callbacks import TrainingCallback

# every optimizer of trainers/base/optim.py, the OptaxRule ones among them
OPTIMIZERS = {
    "Adam": ("Adam", None), "AdamW": ("AdamW", None),
    "amsgrad": ("Adam", {"amsgrad": True}), "eps_root": ("Adam", {"eps_root": 1e-8}),
    "Adagrad": ("Adagrad", None), "Adadelta": ("Adadelta", None),
    "SGD": ("SGD", {"momentum": 0.9, "nesterov": True}),
    "RMSprop": ("RMSprop", {"momentum": 0.5, "centered": True}),
    "Adamax": ("Adamax", None), "RAdam": ("RAdam", None),
}
# conv_mmvae: two PolyMNIST-shaped modalities at latent CONV_LATENT
CONV_DIMS = {"m0": (3, 28, 28), "m1": (3, 28, 28)}
CONV_LATENT, CONV_TRAIN, CONV_EVAL = 16, 16, 8
# the JAX tensor-parallel tests' model: two modalities of 2 and 3 features
TP_DIMS = {"mod1": (2,), "mod2": (3,)}
TP_ROWS = 48


def tp_data():
    rng = np.random.default_rng(3)
    return MultimodalBaseDataset({m: rng.uniform(size=(TP_ROWS, *d)).astype(np.float32)
                                  for m, d in TP_DIMS.items()})


def tp_model(latent: int, seed: int):
    torch.manual_seed(seed)
    return MVTCAE(MVTCAEConfig(n_modalities=2, latent_dim=latent, input_dims=TP_DIMS),
                  device="cpu")


def conv_data():
    rng = np.random.default_rng(4)
    return [MultimodalBaseDataset({m: rng.uniform(size=(n, *d)).astype(np.float32)
                                   for m, d in CONV_DIMS.items()})
            for n in (CONV_TRAIN, CONV_EVAL)]


def conv_mmvae():
    torch.manual_seed(2)
    cfg = BaseAEConfig(latent_dim=CONV_LATENT, input_dim=(3, 28, 28))
    return MMVAE(MMVAEConfig(n_modalities=2, latent_dim=CONV_LATENT, input_dims=CONV_DIMS,
                             K=2, loss="dreg_looser"),
                 encoders={m: EncoderConvMMNIST_adapted(cfg) for m in CONV_DIMS},
                 decoders={m: DecoderConvMMNIST(cfg) for m in CONV_DIMS}, device="cpu")


# cub_mvtcae: the CUB example's two modalities on narrow nets: 3x64x64
# images through the resnets at nfilter 8 (at most 16), captions of CUB_LEN
# tokens through a text encoder of embed 64 and 4 heads (head_dim 16: JAX
# leaves its query, key and value whole on a model axis), CUB_ROWS random
# rows, CUB_BATCH a step over all ranks; SGD at CONV_LR, as its loss of
# ~8e3 sums over 3 x 64 x 64 pixels
CUB_LEN, CUB_VOCAB, CUB_LATENT, CUB_ROWS, CUB_EVAL, CUB_BATCH = 8, 32, 4, 16, 8, 8
CUB_TEXT = dict(embed_size=64, nhead=4, ff_size=64, n_layers=2)
CUB_NF = dict(nfilter=8, nfilter_max=16)


def cub_data():
    rng = np.random.default_rng(6)
    out = []
    for n in (CUB_ROWS, CUB_EVAL):
        lengths = rng.integers(1, CUB_LEN + 1, n)
        out.append(MultimodalBaseDataset({
            "image": rng.uniform(size=(n, 3, 64, 64)).astype(np.float32),
            "text": {"tokens": rng.integers(0, CUB_VOCAB, (n, CUB_LEN)),
                     "padding_mask": (np.arange(CUB_LEN)[None] < lengths[:, None]).astype(
                         np.float32)}}))
    return out


def cub_mvtcae():
    text = (CUB_LEN, CUB_VOCAB)
    encoders = {"image": CUB_Resnet_Encoder(CUB_LATENT, **CUB_NF),
                "text": CubTextEncoder(CUB_LATENT, CUB_LEN, CUB_VOCAB, **CUB_TEXT)}
    decoders = {"image": CUB_Resnet_Decoder(CUB_LATENT, **CUB_NF),
                "text": CubTextDecoderMLP(BaseAEConfig(latent_dim=CUB_LATENT, input_dim=text))}
    generator = torch.Generator().manual_seed(8)
    for m in encoders:
        encoders[m].reset_parameters(generator)
        decoders[m].reset_parameters(generator)
    return MVTCAE(MVTCAEConfig(n_modalities=2, latent_dim=CUB_LATENT,
                               input_dims={"image": (3, 64, 64), "text": text},
                               decoders_dist={"image": "laplace", "text": "categorical"},
                               beta=5.0, alpha=0.9),
                  encoders=encoders, decoders=decoders, device="cpu")


def config(outdir, name, **kw):
    base = dict(output_dir=os.path.join(outdir, name), num_epochs=2, learning_rate=1e-3,
                seed=5, optimizer_cls="SGD", optimizer_params={"momentum": 0.9})
    base.update(kw)
    return BaseTrainerConfig(**base)


def result(trainer) -> dict:
    """The history, the whole weights (live and kept), the whole optimizer
    state and this rank's bytes at rest of every parameter and its
    optimizer state, with those of the cut leaves alone."""
    state = trainer._state
    out = dict(history=trainer.history, best=trainer._best_state,
               live={k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
               world=trainer.mesh.world_size, n_data=trainer.mesh.n_data,
               n_model=trainer.mesh.n_model)
    # copies: a state_dict holds the live state tensors
    if state is None:
        out["optimizer"] = copy.deepcopy(trainer.optimizer.state_dict())
        out["nbytes"] = state_nbytes(trainer.model.parameters(), trainer.optimizer)
        return out
    out["optimizer"] = copy.deepcopy(state.optimizer_state_whole(trainer.optimizer))
    out["nbytes"] = state.nbytes(trainer.optimizer)["params_and_optimizer"]
    out["cut"] = {leaf.name: (tuple(leaf.master.shape), leaf.master.dtype,
                              sorted({v.dtype for v in trainer.optimizer.state.get(
                                  leaf.master, {}).values() if isinstance(v, torch.Tensor)
                                  and v.dim()}, key=str))
                  for leaf in state.leaves if leaf.cut}
    out["placements"] = state.placements
    return out


def replicated_nbytes(res: dict, names) -> int:
    """Bytes of the ``names`` leaves and their optimizer state in a
    replicated run's result."""
    keys = list(res["live"])
    index = {k: i for i, k in enumerate(keys)}
    total = sum(res["live"][k].numel() * res["live"][k].element_size() for k in names)
    for k in names:
        for v in res["optimizer"]["state"].get(index[k], {}).values():
            if isinstance(v, torch.Tensor) and v.dim():
                total += v.numel() * v.element_size()
    return total


def train(trainer):
    trainer.train()
    return result(trainer)


# --------------------------------------------------------------- two ranks
def optimizers_case(outdir):
    out = {}
    for name, (cls, params) in OPTIMIZERS.items():
        for fsdp in (False, True):
            trainer = cases.trainer_of("MVTCAE", os.path.join(outdir, f"opt_{name}_{fsdp}"),
                                       fsdp=fsdp, optimizer_cls=cls, optimizer_params=params,
                                       scheduler_cls=None, scheduler_params=None)
            out[(name, fsdp)] = train(trainer)
    return out


# SGD at a rate the conv model's first steps stay stable at (its loss of
# ~5e3 sums over 2 x 2,352 pixels: at 1e-3 one step raises it a hundredfold,
# and the float32 noise of the gradients with it)
CONV_LR = 1e-5


def conv_trainer(outdir, name, **kw):
    train_set, eval_set = conv_data()
    per_device = 8 // kw.get("n_devices", 1)
    return BaseTrainer(conv_mmvae(), train_set, eval_set, device="cpu",
                       training_config=config(outdir, name, num_epochs=2, learning_rate=CONV_LR,
                                              per_device_train_batch_size=per_device,
                                              per_device_eval_batch_size=per_device, **kw))


def conv_case(outdir, name, **kw):
    return train(conv_trainer(outdir, name, **kw))


def cub_trainer(outdir, name, checkpoint=None, **kw):
    train_set, eval_set = cub_data()
    per_device = CUB_BATCH // kw.get("n_devices", 1)
    return BaseTrainer(cub_mvtcae(), train_set, eval_set, device="cpu", checkpoint=checkpoint,
                       training_config=config(outdir, name, learning_rate=CONV_LR,
                                              per_device_train_batch_size=per_device,
                                              per_device_eval_batch_size=per_device, **kw))


def cub_fsdp_case(outdir):
    """Replicated and ``fsdp`` over data 2, the latter saving sharded at its
    end."""
    out = {}
    for fsdp in (False, True):
        trainer = cub_trainer(outdir, f"cub_{fsdp}", n_devices=2, fsdp=fsdp,
                              **(dict(checkpoint_backend="orbax", steps_saving=2)
                                 if fsdp else {}))
        out[fsdp] = train(trainer)
    out[True]["training_dir"] = trainer.training_dir
    return out


def tp_mvtcae_case(outdir, **kw):
    return train(BaseTrainer(tp_model(4, 5), tp_data(), device="cpu",
                             training_config=config(outdir, "tp_mvtcae", num_epochs=1,
                                                    per_device_train_batch_size=16, seed=11,
                                                    steps_predict=1, **kw)))


def bf16_case(outdir):
    return {fsdp: train(cases.trainer_of("MVTCAE", os.path.join(outdir, f"bf16_{fsdp}"),
                                         fsdp=fsdp, mixed_precision=True))
            for fsdp in (False, True)}


def checkpoint_case(outdir):
    """The run with its checkpoints, and the run resumed from its epoch 2 in
    the same layout."""
    trainer = cases.trainer_of("MVTCAE", os.path.join(outdir, "ckpt"), fsdp=True, num_epochs=3,
                               steps_saving=1, steps_predict=1)
    out = train(trainer)
    out["training_dir"] = trainer.training_dir
    out["resumed"] = train(cases.trainer_of(
        "MVTCAE", os.path.join(outdir, "ckpt_resumed"), fsdp=True, num_epochs=3,
        checkpoint=os.path.join(trainer.training_dir, "checkpoint_epoch_2")))
    return out


def orbax_case(outdir):
    """``checkpoint_case`` with sharded, asynchronous checkpoints."""
    trainer = cases.trainer_of("MVTCAE", os.path.join(outdir, "orbax"), fsdp=True, num_epochs=3,
                               steps_saving=1, checkpoint_backend="orbax")
    out = train(trainer)
    out["training_dir"] = trainer.training_dir
    out["resumed"] = train(cases.trainer_of(
        "MVTCAE", os.path.join(outdir, "orbax_resumed"), fsdp=True, num_epochs=3,
        checkpoint_backend="orbax",
        checkpoint=os.path.join(trainer.training_dir, "checkpoint_epoch_2")))
    return out


def restored(trainer) -> dict:
    """The whole weights and whole optimizer state of a trainer that was
    just built from a checkpoint (a collective of every rank)."""
    state = trainer._state
    if state is None:
        return dict(live=copy.deepcopy(trainer.model.state_dict()),
                    optimizer=copy.deepcopy(trainer.optimizer.state_dict()))
    return dict(live=state.whole_state_dict(),
                optimizer=copy.deepcopy(state.optimizer_state_whole(trainer.optimizer)))


def orbax_checkpoint(outdir: str, epoch: int, run: str = "orbax") -> str:
    """``fsdp_orbax``'s checkpoint of ``epoch`` (or that of the two ranks'
    ``run``) in the two ranks' result folder ``outdir``."""
    parent = os.path.join(outdir, run)
    (training_dir,) = os.listdir(parent)
    return os.path.join(parent, training_dir, f"checkpoint_epoch_{epoch}")


def chunked_case(outdir):
    return {n: train(cases.trainer_of("MMVAE", os.path.join(outdir, f"chunk_{n}"), fsdp=True,
                                      cache_on_device=True, steps_per_execution=n))
            for n in (1, 3)}


def microbatch_case(outdir):
    return {fsdp: train(cases.trainer_of("MMVAE_microbatch", os.path.join(outdir, f"micro_{fsdp}"),
                                         fsdp=fsdp))
            for fsdp in (False, True)}


def telbo_case(outdir):
    return {fsdp: train(cases.trainer_of("TELBO", os.path.join(outdir, f"telbo_{fsdp}"),
                                         fsdp=fsdp, num_epochs=3))
            for fsdp in (False, True)}


# the endpoint of ``fsdp_export``: MVTCAE generating every modality from two
EXPORT_COND, EXPORT_BATCH = ["a", "b"], 8


def export_predictor(model):
    return Predictor(model, cond_mod=EXPORT_COND, batch_size=EXPORT_BATCH, deterministic=True)


class _ExportInTraining(TrainingCallback):
    """At the end of the first epoch, inside ``train()``, try to export."""

    def __init__(self, model, path):
        self.model, self.path, self.outcome = model, path, None

    def on_epoch_end(self, training_config, **kwargs):
        if self.outcome is None:
            try:
                export_predictor(self.model).export(self.path)
                self.outcome = "exported"
            except RuntimeError as err:
                self.outcome = str(err)


def export_case(outdir):
    """The outcome of an export inside ``train()`` under ``fsdp``, the whole
    weights after it, and rank 0's export of the trained model."""
    trainer = cases.trainer_of("MVTCAE", os.path.join(outdir, "export"), fsdp=True)
    inside = _ExportInTraining(trainer.model, os.path.join(outdir, "inside.pt2"))
    trainer.callback_handler.add_callback(inside)
    out = train(trainer)
    out["inside"] = inside.outcome
    if dist.get_rank() == 0:
        out["path"] = export_predictor(trainer.model).export(
            os.path.join(outdir, "fsdp_export.pt2"))
    return out


# -------------------------------------------------------------- four ranks
def orbax_2x2_case(outdir):
    trainer = cases.trainer_of(
        "MVTCAE", os.path.join(outdir, "orbax_2x2"), fsdp=True, n_model_devices=2, num_epochs=4,
        checkpoint_backend="orbax", steps_saving=1,
        checkpoint=orbax_checkpoint(os.path.join(os.path.dirname(outdir), "world2"), 3))
    at_restore = restored(trainer)
    out = train(trainer)
    out.update(restored=at_restore, training_dir=trainer.training_dir)
    return out


def cub_2x2_case(outdir):
    """``cub_fsdp``'s sharded checkpoint restored into data 2 x model 2 with
    ``fsdp``."""
    trainer = cub_trainer(outdir, "cub_2x2", n_devices=2, n_model_devices=2, fsdp=True,
                          checkpoint=orbax_checkpoint(os.path.join(os.path.dirname(outdir),
                                                                   "world2"), 2, "cub_True"))
    return dict(restored(trainer), placements=trainer._state.placements)


def both_case(outdir):
    return train(BaseTrainer(tp_model(8, 7), tp_data(), device="cpu",
                             training_config=config(outdir, "both", n_devices=2,
                                                    n_model_devices=2, fsdp=True,
                                                    per_device_train_batch_size=8, seed=13)))


def cache_2x2_case(outdir):
    """Each rank's block of the row-sharded cache and its batches of one
    epoch (with the host loader's columns beside them), then MVTCAE trained
    from the cache with ``fsdp`` on the 2 x 2 mesh."""
    trainer = cases.trainer_of("MVTCAE", os.path.join(outdir, "cache"), fsdp=True,
                               n_model_devices=2, cache_on_device=True,
                               device_cache_layout="sharded")
    cache = trainer._train_cache
    block = dict(kind=type(cache).__name__, start=cache.start, block=cache.block,
                 rows=cache.data["a"].shape[0])
    plan = trainer._plans["train"]
    trainer.train_loader.set_epoch(0)
    idx, weights = plan.upload()
    batches = [cache.gather(idx[i], weights[i], plan.columns).data
               for i in range(len(idx))]
    host = [b.data for b in trainer.train_loader]
    out = train(trainer)
    out.update(block=block, batches=batches, host=host)
    return out


def jobs(outdir: str, port: str, world: int, rank: int, spec):
    """The worker's jobs, in order, once it joined the gloo group of
    ``world`` ranks at ``127.0.0.1:port``."""
    import datetime

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))

    def job(name, fn):
        return name, lambda: cases.save(fn(), outdir, name)

    if world == 4:
        return [job("both", lambda: both_case(outdir)),
                job("cache_2x2", lambda: cache_2x2_case(outdir)),
                job("orbax_2x2", lambda: orbax_2x2_case(outdir)),
                job("cub_2x2", lambda: cub_2x2_case(outdir))]
    return [job("tp_conv", lambda: conv_case(outdir, "tp_conv", n_model_devices=2)),
            job("fsdp_conv", lambda: conv_case(outdir, "fsdp_conv", n_devices=2, fsdp=True)),
            job("tp_mvtcae", lambda: tp_mvtcae_case(outdir, n_model_devices=2)),
            job("optimizers", lambda: optimizers_case(outdir)),
            job("fsdp_bf16", lambda: bf16_case(outdir)),
            job("fsdp_checkpoint", lambda: checkpoint_case(outdir)),
            job("fsdp_orbax", lambda: orbax_case(outdir)),
            job("fsdp_chunked", lambda: chunked_case(outdir)),
            job("fsdp_telbo", lambda: telbo_case(outdir)),
            job("fsdp_microbatch", lambda: microbatch_case(outdir)),
            job("fsdp_export", lambda: export_case(outdir)),
            job("cub_fsdp", lambda: cub_fsdp_case(outdir)),
            job("cub_tp", lambda: train(cub_trainer(outdir, "cub_tp", n_model_devices=2)))]
