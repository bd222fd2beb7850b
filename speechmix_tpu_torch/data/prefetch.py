"""Device prefetch (port of ``speechmix_tpu.data.prefetch``): a host thread
runs the batch iterator and copies the next `depth` batches to the card
while the current step runs.

On the card each batch is pinned and copied with ``non_blocking=True`` on a
side CUDA stream, and an event is recorded after the copy.  The consumer's
stream waits on that event before it is handed the batch, and every tensor
is ``record_stream``-ed to the consumer's stream: the tensors were
allocated on the side stream, so without that the caching allocator could
give their memory to the next copy while the step still reads it.  On the
CPU the batches are staged as tensors without streams.

As in the JAX package, an exception raised by the source iterator is raised
again in the consumer, and dropping the generator early stops the worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..ops.kernels._cuda import resolve_device

_END = object()


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(v))


def prefetch_to_device(batches: Iterable, device=None,
                       depth: int = 2) -> Iterator:
    """Yield the batches (dicts of arrays or tensors) as dicts of tensors on
    `device` (default: the card; raises without CUDA), staged `depth`
    ahead by a worker thread.  `device` may be a ``parallel.mesh.Mesh``
    (the JAX package's signature): its device; over a mesh each process
    is one rank and its batches are its data rank's rows already (the
    multihost data path)."""
    if hasattr(device, "coords"):   # a parallel.mesh.Mesh
        device = device.device
    device = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def stage(batch):
        if copy_stream is None:
            return {k: _as_tensor(v).to(device) for k, v in batch.items()}, \
                None
        with torch.cuda.stream(copy_stream):
            out = {k: _as_tensor(v).pin_memory().to(device,
                                                    non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not _put(stage(b)):
                    return
        except BaseException as e:  # surface iterator errors to the consumer
            _put((_END, e))
            return
        _put((_END, None))

    t = threading.Thread(target=worker, daemon=True,
                         name="smx-device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for v in batch.values():
                    v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
