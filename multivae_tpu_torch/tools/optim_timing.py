"""Time of one optimizer step over a workload's parameters, on one GPU.

For each ``--model`` of ``tools/workloads.py`` (default ``mmvae_conv``,
``mmvaeplus_partial`` and ``mmvaeplus_k10``) it builds the model on the
card, gives every parameter a random gradient, and times three optimizers
over its parameters at lr 1e-3: ``torch.optim.Adam`` (what
``make_optimizer("Adam")`` builds), the same update through ``OptaxRule``
(optax's Adam, computed by the port's own rule), and
``make_optimizer("Adam", amsgrad=True)`` (``OptaxRule`` with AMSGrad, what
``mmvaeplus_k10`` trains with). A time is the wall time of one step
(``torch.cuda.synchronize`` around 20 steps), the median of 5 such runs
after 5 warm-up steps.

``--root DIR`` imports the port from another checkout, so that two versions
are timed the same way in one run. Run it by path, from the root of a
checkout:

    python3 multivae_tpu_torch/tools/optim_timing.py [--model mmvae_conv ...]
        [--root DIR]

Prints the card's name and power limit, then one JSON line per model.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

STEPS, REPEATS, WARMUP = 20, 5, 5
LR = 1e-3
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=0.0,
            nesterov=False, amsgrad=False, decoupled=False, threshold=None)


def step_ms(opt):
    """Median wall ms of one ``opt.step()``."""
    for _ in range(WARMUP):
        opt.step()
    runs = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            opt.step()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / STEPS)
    return statistics.median(runs)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", nargs="+",
                        default=["mmvae_conv", "mmvaeplus_partial", "mmvaeplus_k10"])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose multivae_tpu_torch is timed (default: this one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("optim_timing needs a CUDA device.")
    sys.path.insert(0, os.path.abspath(args.root))
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers.base import optim

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for name in args.model:
        model = workloads.build(name, n=workloads.BATCH[name], n_eval=0).model
        params = [p for p in model.parameters() if p.requires_grad]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        line = {"root": args.root, "model": name, "tensors": len(params),
                "numel": sum(p.numel() for p in params)}
        for label, make in (
                ("torch_adam_ms", lambda: optim.make_optimizer("Adam", params, LR)),
                ("optax_adam_ms", lambda: optim.OptaxRule(params, optim._adam_rule,
                                                          LR, **ADAM)),
                ("optax_amsgrad_ms", lambda: optim.make_optimizer(
                    "Adam", params, LR, {"amsgrad": True}))):
            with torch.no_grad():
                saved = [p.detach().clone() for p in params]
                line[label] = step_ms(make())
                for p, s in zip(params, saved):
                    p.copy_(s)
        print(json.dumps(line))


if __name__ == "__main__":
    main()
