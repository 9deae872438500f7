"""Training steps/s through each data path of a checkout, on one GPU.

For each ``--model`` of ``tools/workloads.py`` (default ``mvtcae_conv``,
``mmvaeplus_partial`` and ``dmvae_mnist_svhn``), on ``--steps`` batches of
its random rows and no eval set, it trains ``--epochs`` epochs with
``BaseTrainer`` from the seeded weights, float32 without TF32, four times:
through the checkout's host path, then through the device cache, then the
cache again, then the host path again (where the checkout's
``BaseTrainerConfig`` has no ``cache_on_device``, the host path all four
times), so that neither path always runs first. Steps/s come from CUDA
events after each optimizer step: the gaps between the steps of one epoch
(the first step and the epoch ends left out), as in ``chip_smoke.py``.

``--root DIR`` runs another checkout's port (a parent unpacked with
``git archive``), so that versions are timed the same way in one call: run
them alternately. Run it by path, from the root of a checkout:

    python3 multivae_tpu_torch/tools/data_path_timing.py [--model NAME ...]
        [--steps 32] [--epochs 2] [--root DIR]

Prints the card's name and power limit, then one JSON line per model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch


def steps_per_s(trainer) -> float:
    """Train ``trainer`` to its end; its steps/s within epochs."""
    ends = []

    def on_step(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append((len(trainer.history), ev))

    trainer.optimizer.register_step_post_hook(on_step)
    trainer.train()
    torch.cuda.synchronize()
    gaps = [a.elapsed_time(b) for (ea, a), (eb, b) in zip(ends, ends[1:]) if ea == eb]
    return len(gaps) / (sum(gaps) / 1e3)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", nargs="+",
                        default=["mvtcae_conv", "mmvaeplus_partial", "dmvae_mnist_svhn"])
    parser.add_argument("--steps", type=int, default=32, help="steps an epoch")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose multivae_tpu_torch is timed (default: this one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("data_path_timing needs a CUDA device.")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from multivae_tpu_torch.tools import workloads
    from multivae_tpu_torch.trainers import BaseTrainer, BaseTrainerConfig

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    has_cache = "cache_on_device" in {f.name for f in dataclasses.fields(BaseTrainerConfig)}
    order = ("host", "cached", "cached", "host") if has_cache else ("host",) * 4
    for name in args.model:
        rows = args.steps * workloads.BATCH[name]
        line = {"root": args.root, "model": name, "rows": rows, "epochs": args.epochs}
        for path in order:
            w = workloads.build(name, n=rows, n_eval=0)
            extra = {"cache_on_device": True} if path == "cached" else {}
            trainer = BaseTrainer(w.model, w.train, training_config=BaseTrainerConfig(
                output_dir=os.path.join("build", "data_path_timing"),
                num_epochs=args.epochs, seed=0, **w.trainer_kwargs, **extra))
            line.setdefault(f"{path}_steps_per_s", []).append(steps_per_s(trainer))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
