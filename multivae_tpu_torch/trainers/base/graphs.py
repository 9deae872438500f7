"""CUDA graphs of the trainer's chunks of steps (``steps_per_execution``).

The card's counterpart of the JAX trainer's ``lax.scan`` chunk programs
(``multivae_tpu/trainers/base/base_trainer.py``, ``_compiled_cached_train_chunk``
and ``_compiled_cached_eval_chunk``): a chunk of N steps over the device
cache is captured once per distinct key (its length, and the learning
rates a graph would bake in) as one ``torch.cuda.CUDAGraph`` and replayed,
so the host issues one launch a chunk instead of every kernel of N steps.

- The first chunk after the graphs were built or dropped runs eagerly on
  the capture stream: it creates what a step creates lazily (the optimizer
  state, the gradients, the cuBLAS workspace, the mixture kernels'
  attributes; under a process group, the NCCL communicator and the
  gradient reducer's presence mask, which the captures reuse) outside any
  capture, and takes no extra step.
- Under an NCCL group a capture takes the chunk's collectives (the
  gradient all-reduce, a loss's normalizers, the row-sharded cache's
  exchange) into the graph: each replay runs them with every rank's
  replay. A gloo group cannot be captured; the trainer refuses it on
  CUDA.
- The chunk's random draws come from a ``torch.Generator`` registered with
  every graph, so each replay draws what the eager loop would have drawn,
  and the generator's state after a replay is the eager loop's.
- A capture that fails raises, naming the first error and the line that
  made it. Nothing falls back to the eager loop on the card.
- The mixture kernels' launch counts (``ops/mixture.launches``) advance
  by the launches captured in a graph at each of its replays, not at its
  capture (``chip_smoke.py``'s ``graphed_steps`` holds them to the
  kernels torch.profiler sees in a replay).

On a device other than CUDA (the CPU tests) every chunk runs eagerly.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Callable, Hashable

import torch

from ...ops import mixture

_PACKAGE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _first_error(exc: BaseException) -> BaseException:
    """The error a failed capture started from (the later ones a
    ``capture_end`` adds to it come first in the chain)."""
    seen = set()
    while exc.__context__ is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc = exc.__context__
    return exc


def _where(exc: BaseException) -> str:
    """``file:line (code)`` of the deepest frame of ``exc`` in this package,
    else its deepest frame."""
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if f.filename.startswith(_PACKAGE)]
    frame = (ours or frames or [None])[-1]
    if frame is None:
        return "an unknown place"
    return f"{os.path.relpath(frame.filename, os.path.dirname(_PACKAGE))}:{frame.lineno} ({frame.line})"


class ChunkGraphs:
    """The captured chunks of one kind (train or eval) of one trainer.

    Args:
        device: the trainer's device; graphs only on CUDA.
        generator: the ``torch.Generator`` the chunk draws from.
        name: "train" or "eval", for the messages.
    """

    def __init__(self, device, generator: torch.Generator, name: str):
        self.device = torch.device(device)
        self.generator = generator
        self.name = name
        self.graphs = {}
        self.warm = False
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._stream = None

    def drop(self):
        """Forget every graph; the next chunk runs eagerly again."""
        self.graphs.clear()
        self.warm = False

    def run(self, key: Hashable, fn: Callable[[], None], baked: Hashable = ()):
        """Run the chunk ``fn``: eagerly off CUDA or when not warm, else by
        replaying the graph of ``key`` (captured first if new). ``baked`` is
        what a graph holds fixed besides its inputs' addresses (the learning
        rates an optimizer keeps as numbers): a change drops the graphs of
        other values."""
        if self.device.type != "cuda":
            fn()
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if not self.warm:
            self._on_stream(fn)
            self.warm = True
            return
        key = (key, baked)
        if any(k[1] != baked for k in self.graphs):
            self.graphs = {k: v for k, v in self.graphs.items() if k[1] == baked}
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(fn)
        graph, captured = entry
        graph.replay()
        self.replays += 1
        for k, n in captured.items():
            mixture.launches[k] += n

    def _on_stream(self, fn):
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()
        current.wait_stream(self._stream)

    def _capture(self, fn):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = dict(mixture.launches)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                fn()
        except Exception as e:   # any error inside a capture: raise it, named
            first = _first_error(e)
            raise RuntimeError(
                f"CUDA graph capture of a {self.name} chunk failed: "
                f"{type(first).__name__}: {first} -- at {_where(first)}") from e
        finally:
            captured = {k: mixture.launches[k] - before[k] for k in before}
            mixture.launches.update(before)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return graph, captured
