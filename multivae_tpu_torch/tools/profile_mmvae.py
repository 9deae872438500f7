"""Where the time of an MMVAE DReG training step goes, on one GPU.

Builds the full-width MMVAE of ``chip_smoke.py`` (5 modalities of
3x28x28, latent 512, K=10, default MLP nets, Laplace decoders, DReG,
batch 256, Adam 1e-3, float32 without TF32), trains one warm-up epoch of
``--steps`` steps with ``BaseTrainer``, then profiles a second epoch with
``torch.profiler`` and prints:

- the host wall time per step and the device's busy and idle shares over
  the profiled epoch (busy = the sum of kernel durations on the device);
- device time by kernel class (matmul, mixture kernels, optimizer,
  reductions, the rest) and the top kernels by device time.

Run from the root of a checkout:

    python3 -m multivae_tpu_torch.tools.profile_mmvae [--steps 8]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import time

import numpy as np
import torch

_CLASSES = (
    ("mixture", re.compile(r"mixture_")),
    ("matmul", re.compile(r"gemm|cutlass|xmma|sm90_|ampere_|cublas", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
    ("reduction", re.compile(r"reduce|logsumexp|softmax", re.I)),
)


def _kernel_class(name: str) -> str:
    for label, pattern in _CLASSES:
        if pattern.search(name):
            return label
    return "elementwise/other"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mmvae needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..data import MultimodalBaseDataset
    from ..models import MMVAE, MMVAEConfig
    from ..trainers import BaseTrainer, BaseTrainerConfig

    n_mods, shape, batch = 5, (3, 28, 28), 256
    rng = np.random.default_rng(0)
    data = {f"m{i}": rng.random((batch * args.steps, *shape), dtype=np.float32)
            for i in range(n_mods)}
    model = MMVAE(MMVAEConfig(
        n_modalities=n_mods, latent_dim=512, K=10,
        input_dims={m: shape for m in data},
        decoders_dist={m: "laplace" for m in data}), seed=0)
    trainer = BaseTrainer(model, MultimodalBaseDataset(data),
                          training_config=BaseTrainerConfig(
                              output_dir=os.path.join("build", "profile_mmvae"),
                              per_device_train_batch_size=batch, num_epochs=2,
                              learning_rate=1e-3))
    trainer.train_step(1)  # warm-up: kernel builds, cuBLAS heuristics, allocator
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_step(2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_kernel = collections.Counter()
    launches = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] += evt.device_time_total
            launches[evt.name] += 1
    if not by_kernel:
        raise SystemExit("the profiler recorded no device events")
    busy_us = sum(by_kernel.values())
    by_class = collections.Counter()
    for name, us in by_kernel.items():
        by_class[_kernel_class(name)] += us

    summary = {
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "wall_ms_per_step": wall_us / args.steps / 1e3,
        "device_busy_ms_per_step": busy_us / args.steps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "device_ms_per_step_by_class": {
            k: v / args.steps / 1e3 for k, v in by_class.most_common()},
    }
    print(json.dumps(summary))
    print("top kernels by device time (ms per step, launches per step):")
    for name, us in by_kernel.most_common(15):
        print(f"  {us / args.steps / 1e3:9.4f}  {launches[name] / args.steps:5.1f}  "
              f"{name[:110]}")


if __name__ == "__main__":
    main()
