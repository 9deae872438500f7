"""Background prefetch: the host gather and the host-to-device copy of the
next batches run while the current step computes.

Counterpart of ``multivae_tpu/data/prefetch.py``. A producer thread
iterates the wrapped loader (whose ``get_batch`` runs the threaded native
gather) and keeps ``depth`` batches in flight. On a CUDA device it copies
each batch into a ring of ``depth + 1`` page-locked host buffers, reused
from batch to batch, and from there to the device on a side stream; the
consumer's stream waits on the copy's event, and each device tensor is
recorded on the consumer's stream so that the caching allocator does not
hand its memory back to the side stream while a step still reads it. On
the CPU the thread only assembles the batches: no pinning, no stream.

The producer draws no noise (the trainer's generator stays on the
consumer's thread), so prefetching moves no loss. Shutdown follows the
JAX module: a consumer that stops early (``break``, an exception) signals
the producer, drains the queue and joins it; a producer that outlives the
grace join is handed to the next ``__iter__`` of the same loader, which
waits for it before starting another, so two producers never iterate one
loader at once.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Sequence

import torch

from .batch import MultimodalBatch, map_tensors

# Grace period for the producer to exit on consumer shutdown before the
# thread is handed to the NEXT __iter__ to finish joining.
_JOIN_TIMEOUT = 5.0


class _PinnedSlot:
    """One entry of the ring: page-locked buffers for one batch's tensors,
    and the event of the last copy out of them."""

    def __init__(self):
        self.buffers = []
        self.copied = None

    def stage(self, batch: MultimodalBatch, skip) -> MultimodalBatch:
        if self.copied is not None:
            self.copied.synchronize()   # the last copy out of these buffers is done
        position = itertools.count()

        def pin(t):
            i = next(position)
            if i == len(self.buffers):
                self.buffers.append(None)
            buf = self.buffers[i]
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self.buffers[i] = torch.empty(t.shape, dtype=t.dtype,
                                                    pin_memory=True)
            return buf.copy_(t)

        return map_tensors(pin, batch, skip)


class PrefetchLoader:
    """Wrap a DataLoader with a thread that prepares batches ahead.

    Args:
        loader: the underlying DataLoader (yields host batches).
        device: where the batches go.
        depth: batches kept in flight.
        host_fields: batch fields left on the host (the evaluators read
            ``weights`` and ``labels`` there, as from the device cache's
            loader).
    """

    def __init__(self, loader, device, depth: int = 2, host_fields: Sequence[str] = ()):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.host_fields = tuple(host_fields)
        self._ring = None
        self._stream = None

    @property
    def dataset(self):
        return self.loader.dataset

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def _producer_setup(self):
        """The CUDA side stream and the pinned ring, made once per loader."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
            self._ring = [_PinnedSlot() for _ in range(self.depth + 1)]

    def _to_device(self, batch: MultimodalBatch, step: int):
        """(the batch on the device, the event its copies complete), from
        the producer's thread."""
        if self.device.type != "cuda":
            return batch, None   # the loader's batches are on the CPU already
        pinned = self._ring[step % len(self._ring)].stage(batch, self.host_fields)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            moved = map_tensors(lambda t: t.to(self.device, non_blocking=True), pinned,
                                self.host_fields)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self._ring[step % len(self._ring)].copied = ready
        return moved, ready

    def _consume(self, moved: MultimodalBatch, ready) -> MultimodalBatch:
        if ready is None:
            return moved
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)

        def hold(t):
            if t.device.type == "cuda":
                t.record_stream(stream)
            return t

        return map_tensors(hold, moved)

    def __iter__(self):
        # A previous producer can outlive its grace join (blocked inside the
        # loader's own iteration rather than in put()); wait for it so two
        # producers never iterate the loader at once. It is kept on the
        # UNDERLYING loader, which outlives any one PrefetchLoader.
        prev = getattr(self.loader, "_prefetch_producer_thread", None)
        if prev is not None and prev.is_alive():
            prev.join()
        self.loader._prefetch_producer_thread = None
        if self.device.type == "cuda":
            self._producer_setup()
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        error = []

        def put(item) -> bool:
            """Bounded put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for step, batch in enumerate(self.loader):
                    if stop.is_set() or not put(self._to_device(batch, step)):
                        return
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield self._consume(*item)
        finally:
            # the consumer may stop early: signal the producer and drain the
            # queue so it never blocks forever holding batches
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=_JOIN_TIMEOUT)
            if thread.is_alive():
                self.loader._prefetch_producer_thread = thread
        if error:
            raise error[0]
