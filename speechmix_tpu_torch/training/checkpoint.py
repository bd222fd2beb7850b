"""Checkpoints (port of ``speechmix_tpu.training.checkpoint``, its npz
backend): step-indexed files with resume-from-latest and best-step
retention.

The files are the JAX package's: ``<dir>/step_<N>.npz`` holding
``__paths__`` (the "/"-joined key strings of the JAX checkpoint tree
``{"params", "opt_state", "step"}``) and ``arr_<i>``, beside
``step_<N>.npz.meta.json`` ({"step", "metrics"}).  The parameters are in
the JAX layout (``convert.tree_to_jax_layout``) and the optimizer state in
optax's (``convert.train_state_to_jax``), so a run begun by either package
resumes in the other.

``save_total_limit`` pruning never deletes the best-eval_loss checkpoint,
so load-best-at-end always has its target.  Over a mesh the npz file holds
the whole state: the trainer gathers it and rank 0 writes it, and every
rank reads it back and takes its share.

The "orbax" backend, the JAX package's sharding-aware one, is in the port
``torch.distributed.checkpoint``: ``<dir>/step_<N>/`` written by every
rank, each its own shards (its model share of the parameters, the
optimizer leaves it owns under ZeRO-1, the step and the count; replicas
written once), with no gather to one host, beside ``step_<N>.meta.json``
({"step", "metrics"}).  These files are the port's own: the JAX package's orbax
archives and these cannot read each other, and a run restores them only
on the mesh shape that wrote them.  Pruning, best-step retention and the
error of a damaged archive (the first failure is raised) behave as the JAX
package's.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np

from .. import convert


def save_pytree_npz(path: str, tree):
    """Write a tree of arrays (dicts and lists) as the JAX package does:
    ``__paths__`` and ``arr_<i>`` in the tree's order."""
    flat = convert.flatten_with_paths(tree)
    arrays = {f"arr_{i}": np.asarray(leaf) for i, (_, leaf) in
              enumerate(flat)}
    np.savez(path, __paths__=np.array([p for p, _ in flat], dtype=object),
             **arrays)


def load_pytree_npz(path: str) -> dict:
    """{path: array} of an archive written by save_pytree_npz (of either
    package), in its order."""
    data = np.load(path, allow_pickle=True)
    return {p: data[f"arr_{i}"] for i, p in enumerate(data["__paths__"])}


class CheckpointManager:
    """Step-indexed checkpoints with save_total_limit pruning (the best-
    eval_loss step is never pruned) and latest / best tracking.  backend
    "npz" (the JAX package's files) or "orbax" (the port's sharded files);
    mesh: the rank's ``parallel.mesh.Mesh`` (the orbax backend's keys)."""

    def __init__(self, directory: str, save_total_limit: int = 2,
                 backend: str = "npz", mesh=None):
        if backend not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.directory = directory
        self.save_total_limit = save_total_limit
        self.backend = backend
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    # paths -----------------------------------------------------------------
    def _step_path(self, step: int) -> str:
        suffix = ".npz" if self.backend == "npz" else ""
        return os.path.join(self.directory, f"step_{step}{suffix}")

    def _meta_path(self, step: int) -> str:
        return self._step_path(step) + ".meta.json"

    def _step_paths(self):
        pattern = (r"step_(\d+)\.npz$" if self.backend == "npz"
                   else r"step_(\d+)$")
        out = []
        for name in os.listdir(self.directory):
            m = re.match(pattern, name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def _meta(self, path):
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                return json.load(f)
        return {}

    # save / restore --------------------------------------------------------
    def save(self, step: int, state, metrics: Optional[dict] = None):
        """Checkpoint the TrainState `state` (a synchronous copy to the
        host: the next in-place step may start once this returns).  npz:
        the whole state, by one process; orbax: this rank's shares, by
        every rank of the mesh."""
        path = self._step_path(step)
        meta = {"step": step, "metrics": metrics or {}}
        if self.backend == "npz":
            save_pytree_npz(path, convert.train_state_to_jax(state))
        else:
            import torch.distributed.checkpoint as dcp
            if self._rank0() and os.path.exists(path):
                shutil.rmtree(path)
            self._barrier()
            dcp.save(_shard_dict(state, self.mesh), checkpoint_id=path)
        if self._rank0():
            with open(self._meta_path(step), "w") as f:
                json.dump(meta, f)
            self._prune()
        if self.backend == "orbax":
            self._barrier()
        return path

    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self):
        import torch.distributed as dist
        if self.mesh is not None and self.mesh.distributed:
            dist.barrier()

    def best_step(self, metric: str = "eval_loss") -> Optional[int]:
        """The step with the lowest recorded eval metric."""
        best, best_val = None, float("inf")
        for step, path in self._step_paths():
            val = self._meta(path).get("metrics", {}).get(metric)
            if val is not None and val < best_val:
                best, best_val = step, val
        return best

    def _prune(self):
        best = self.best_step()
        steps = self._step_paths()
        removable = [(s, p) for s, p in steps if s != best]
        excess = len(steps) - self.save_total_limit
        for _, path in removable[:max(excess, 0)]:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
            if os.path.exists(path + ".meta.json"):
                os.remove(path + ".meta.json")

    def latest_step(self) -> Optional[int]:
        steps = self._step_paths()
        return steps[-1][0] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """(TrainState, meta) of checkpoint `step` (default: the latest),
        written into the tensors of `state` in place; (None, None) when
        there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self._step_path(step)
        if self.backend == "npz":
            state = convert.train_state_from_jax(load_pytree_npz(path), state)
            return state, self._meta(path)
        import torch.distributed.checkpoint as dcp
        meta = self._meta(path)
        want = _shard_dict(state, self.mesh)
        try:
            dcp.load(want, checkpoint_id=path)
        except Exception as first_err:
            # an archive from before an optional parameter existed keeps
            # the live value; if that fails too, the archive is bad: raise
            # the first error
            kept = {k: v for k, v in want.items()
                    if not any(s in k for s in
                               convert._OPTIONAL_LEAF_SUBSTRINGS)}
            if len(kept) == len(want):
                raise
            try:
                dcp.load(kept, checkpoint_id=path)
            except Exception:
                raise first_err
        return type(state)(state.params, {**state.opt_state,
                                          "count": int(want["count"])},
                           int(want["step"])), meta


def _shard_dict(state, mesh) -> dict:
    """{key: tensor} of this rank's shares of a TrainState, keyed so that
    replicas of a share write once: the parameters by model rank, the
    optimizer leaves this rank holds (ZeRO-1: those it owns) by model
    rank."""
    import torch
    from ..training.freezing import tree_paths
    m = f"@model{mesh.model_rank}of{mesh.n_model}" if mesh is not None \
        else "@model0of1"
    out = {"step": torch.tensor(int(state.step)),
           "count": torch.tensor(int(state.opt_state["count"])),
           **{f"params/{p}{m}": t for p, t in tree_paths(state.params)}}
    for field, tree in state.opt_state.items():
        if field == "count":
            continue
        out.update({f"opt/{field}/{p}{m}": t for p, t in tree_paths(tree)
                    if t is not None})
    return out
