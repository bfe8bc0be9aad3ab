"""Host-to-device prefetch (the port's counterpart of
owl_audio_exps_tpu/data/prefetch.py ``device_prefetch``): a background
thread reads the host iterator and moves each batch to the device, with
``size`` batches in flight, so the step does not wait on input.

On a CUDA device each array is copied into pinned host memory and sent
with ``non_blocking`` on a side stream; the batch carries the event of
its copy, and the consumer's stream waits on that event (a device-side
wait, no host sync) before the batch is handed out. On the CPU the
arrays become tensors. Arrays arrive as loaded, with no cast: the
trainers' losses cast, as the JAX package's trainers, whose ``put_fn``
(the stacked batch put) does not cast either. An error of the host
iterator reaches the consumer, and the stream ends when the iterator is
exhausted. Closing the stream, or the interpreter's exit, stops the
worker and waits for the batch it holds.

The consumer's side counts, over every stream of the process (read and
reset like the kernels' launch counters): ``batches`` handed out,
``empty_gets`` (gets that found no batch ready) and ``wait_s`` (seconds
blocked on the next batch); under a profiler capture the wait is the
span ``owl.data.wait`` (utils/profiling.py).
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span

_END = object()

batches = 0
empty_gets = 0
wait_s = 0.0


def counts():
    """The consumer's counters as they stand: ``batches``,
    ``empty_gets`` and ``wait_s``."""
    return {"batches": batches, "empty_gets": empty_gets, "wait_s": wait_s}


def _put(batch, device: torch.device,
         stream: Optional["torch.cuda.Stream"]):
    """A list of host arrays -> (list of tensors on ``device``, the copy's
    event or None)."""
    def leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if stream is not None:
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    if stream is None:
        return [leaf(x) for x in batch], None
    with torch.cuda.stream(stream):
        out = [leaf(x) for x in batch]
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def device_prefetch(iterator: Iterator, device="cuda", size: int = 2):
    """Wrap a host iterator of batches (lists of numpy arrays); yields
    them as lists of tensors on ``device`` (the card unless the caller
    asks for the CPU) with ``size`` batches in flight."""
    global batches, empty_gets, wait_s
    device = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def offer(item) -> bool:
        """Queue ``item``; False once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not offer(_put(batch, device, stream)):
                    return
            offer(_END)
        except Exception as e:   # the consumer raises it
            offer(e)

    def halt():
        """Stop the worker and wait for its batch in hand: the interpreter
        would stop a daemon thread at exit inside a torch call, which
        aborts the process."""
        stop.set()
        thread.join(timeout=30)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    atexit.register(halt)
    try:
        while True:
            t0 = time.perf_counter()
            with span("owl.data.wait"):
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    empty_gets += 1
                    item = q.get()
            wait_s += time.perf_counter() - t0
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            batch, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for t in batch:
                    # memory made on the side stream is used on this one
                    t.record_stream(consumer)
            batches += 1
            yield batch
    finally:
        atexit.unregister(halt)
        halt()
