"""One rank of the gloo group of ``test_torch_data_parallel.py``.

Run as ``python torch_dp_worker.py RANK WORLD PORT OUTDIR [JAX_CASES]
[--cases MODULE]`` with ``tests/`` and the repo on ``PYTHONPATH``: runs
every case of ``torch_dp_cases`` in order (or the jobs of ``MODULE``'s
``jobs(outdir, port, world, rank, spec)``), saving each result in
``OUTDIR``. The first
case's trainer opens the gloo group at ``127.0.0.1:PORT`` from its
``coordinator_address``, ``num_processes`` and ``process_id`` (the port's
finite timeout on every collective); the others join it. A case that
raises leaves its traceback in ``<case>_rank<r>.err`` and the next case
goes on after a barrier. The comparisons with the JAX trainer
(``JAX_CASES``, a JSON file the test writes) come last: only they import
JAX, on the CPU, for its draws.
"""

import importlib
import json
import logging
import os
import sys
import traceback

import torch
import torch.distributed as dist


def main():
    args = sys.argv[1:]
    module = None
    if "--cases" in args:
        at = args.index("--cases")
        module = args[at + 1]
        del args[at:at + 2]
    rank, world, port, outdir = int(args[0]), int(args[1]), args[2], args[3]
    jax_cases = args[4] if len(args) > 4 else None
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    if module is not None:
        run(importlib.import_module(module).jobs(outdir, port, world, rank, jax_cases), rank,
            outdir)
        return
    import torch_dp_cases as cases

    first, *others = cases.CASES
    jobs = [(first, lambda: cases.run_case(first, outdir,
                                           coordinator_address=f"127.0.0.1:{port}",
                                           num_processes=world, process_id=rank))]
    jobs += [(case, lambda case=case: cases.run_case(case, outdir)) for case in others]
    jobs += [("resume", lambda: cases.resume_case(outdir)),
             ("refusals", lambda: cases.refusal_case(outdir)),
             ("reducer", lambda: cases.reducer_case(outdir))]
    if jax_cases is not None:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from torch_dp_jax import run_fed

        with open(jax_cases) as f:
            for name, spec in json.load(f).items():
                jobs.append((name, lambda name=name, spec=spec: run_fed(name, spec, outdir)))
    run(jobs, rank, outdir)


def run(jobs, rank, outdir):
    """Each ``(name, job)`` in turn, a barrier after each; a job that raises
    leaves its traceback in ``<name>_rank<r>.err``."""
    for name, job in jobs:
        try:
            job()
        except Exception:
            with open(os.path.join(outdir, f"{name}_rank{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
        dist.barrier()
    dist.destroy_process_group()
    print("DONE", rank, flush=True)


if __name__ == "__main__":
    main()
