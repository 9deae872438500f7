"""Where the time of a training step goes, on one GPU.

Builds one full-width workload of ``tools/workloads.py`` (``--model``:
``mmvae``, the MMVAE of ``chip_smoke.py`` trained with DReG, by default;
``mvtcae_mlp``; ``mvtcae_conv``; ``mmvae_conv``; ``mmvaeplus_partial``;
``mmvaeplus_k10``; ``cmvae_polymnist``; ``mvae_conv``; ``mopoe_conv``;
``crmvae_resnet``; ``dmvae_mnist_svhn``; ``jmvae_conv``; ``telbo_conv``;
``jnf_conv``; ``cvae_tutorial``; ``mhvae_polymnist``; ``nexus_e2e``; each
at its own batch, float32 without TF32), trains one warm-up epoch of ``--steps`` steps with the workload's
trainer (``BaseTrainer``; the ``MultistageTrainer`` for ``telbo_conv`` and
``jnf_conv``, whose epochs here are in the stage ``--stage``, 1 by
default: the profile calls ``train_step`` alone), then profiles a second
epoch with ``torch.profiler`` and prints:

- the host wall time per step and the device's busy and idle shares over
  the profiled epoch (busy = the sum of kernel and copy durations on the
  device; user annotations such as the optimizer's span are not counted);
- device time by kernel class (mixture kernels, convolutions, matmul,
  optimizer, reductions, the rest) and the top kernels by device time.

``--cache`` trains with ``cache_on_device`` (the batches gathered from the
dataset on the card) instead of the host path. ``--steps-per-execution N``
(with the cache) runs the steps as CUDA graphs of N steps: a second
warm-up epoch captures them, so the profiled epoch only replays.
``--mixed-precision`` trains with the trainer's bfloat16
``mixed_precision`` (the loss in bf16 on bf16 copies of the weights; the
bf16 mixture kernels).

Run from the root of a checkout:

    python3 -m multivae_tpu_torch.tools.profile_mmvae [--steps 8] [--model mvtcae_conv]
        [--stage 2] [--cache] [--steps-per-execution 8] [--mixed-precision]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import time

import torch

from . import workloads

_CLASSES = (
    ("mixture", re.compile(r"mixture_")),
    # cuDNN's convolution kernels (forward, data and weight gradients)
    ("conv", re.compile(r"conv|cudnn|fprop|dgrad|wgrad|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|xmma|sm90_|ampere_|cublas", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
    ("reduction", re.compile(r"reduce|logsumexp|softmax", re.I)),
)


def _kernel_class(name: str) -> str:
    for label, pattern in _CLASSES:
        if pattern.search(name):
            return label
    return "elementwise/other"


def device_times(events):
    """(device us by kernel name, launches by kernel name) of profiler
    events. A user annotation's device-side span (``Optimizer.step#Adam.step``)
    covers kernels that are counted on their own, so it is left out."""
    by_kernel, launches = collections.Counter(), collections.Counter()
    for evt in events:
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            by_kernel[evt.name] += evt.device_time_total
            launches[evt.name] += 1
    return by_kernel, launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--model", choices=workloads.NAMES, default="mmvae")
    parser.add_argument("--stage", type=int, default=1,
                        help="the stage of a two-stage model (telbo_conv, jnf_conv)")
    parser.add_argument("--cache", action="store_true",
                        help="train with cache_on_device (the data on the card)")
    parser.add_argument("--steps-per-execution", type=int, default=1,
                        help="steps a CUDA graph (implies --cache)")
    parser.add_argument("--mixed-precision", action="store_true",
                        help="train with the trainer's bf16 mixed_precision")
    args = parser.parse_args()
    graphed = args.steps_per_execution > 1
    if not torch.cuda.is_available():
        raise SystemExit("profile_mmvae needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ..trainers import BaseTrainer, BaseTrainerConfig

    w = workloads.build(args.model, n=workloads.BATCH[args.model] * args.steps, n_eval=0)
    trainer = (w.trainer_cls or BaseTrainer)(
        w.model, w.train, training_config=BaseTrainerConfig(
            output_dir=os.path.join("build", "profile_mmvae"), num_epochs=3,
            cache_on_device=args.cache or graphed,
            steps_per_execution=args.steps_per_execution,
            mixed_precision=args.mixed_precision, **w.trainer_kwargs))
    if hasattr(w.model, "set_stage"):
        w.model.set_stage(args.stage)
    trainer.train_step(1)  # warm-up: kernel builds, cuBLAS heuristics, allocator
    if graphed:
        trainer.train_step(2)  # the captures
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_step(3 if graphed else 2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_kernel, launches = device_times(prof.events())
    if not by_kernel:
        raise SystemExit("the profiler recorded no device events")
    busy_us = sum(by_kernel.values())
    by_class = collections.Counter()
    for name, us in by_kernel.items():
        by_class[_kernel_class(name)] += us

    summary = {
        "device": torch.cuda.get_device_name(0),
        **({} if args.model == "mmvae" else {"model": args.model}),
        **({"stage": args.stage} if hasattr(w.model, "set_stage") else {}),
        "data": "device cache" if trainer._train_cache is not None else "host",
        "steps_per_execution": args.steps_per_execution,
        "mixed_precision": args.mixed_precision,
        "graph_replays": trainer._graphs["train"].replays,
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
