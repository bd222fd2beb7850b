"""Start ranks in fresh processes and collect what they return.

``spawn(fn, world, args)`` starts `world` processes with the "spawn" method
(forking after CUDA is up fails), each of which joins a process group
(``init_method``: a ``file://`` store or ``tcp://localhost:<port>``),
calls ``fn(rank, *args)`` and sends back its return value.  The group has
a timeout, so a rank left waiting in a collective by a rank that raised
fails too; the parent waits at most ``timeout_s`` in all, then kills every
rank still running and raises.  Build the CUDA kernels in the parent
first (``ops.kernels.build_all``): ranks that build at once race on one
directory.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback


def _entry(rank, world, init_method, backend, threads, group_timeout_s,
           fn, args, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass


def spawn(fn, world: int, args=(), *, init_method: str,
          backend: str = "gloo", threads: int = 1, timeout_s: float = 300.0,
          group_timeout_s: float = 120.0) -> list:
    """[fn(rank, *args) for each rank], run in `world` spawned processes;
    raises RuntimeError with the first failing rank's traceback, or on the
    timeout (every rank is stopped either way)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, init_method, backend, threads,
                               group_timeout_s, fn, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, failure = {}, None
    try:
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"timed out after {timeout_s} s with ranks " \
                          f"{sorted(set(range(world)) - set(got))} running"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} exited with code " \
                              f"{procs[dead[0]].exitcode}"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]


def file_store(directory: str) -> str:
    """A ``file://`` init_method in `directory` (no port to collide on)."""
    path = os.path.join(os.path.abspath(directory), "torch_dist_store")
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path
