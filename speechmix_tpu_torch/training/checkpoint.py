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
so load-best-at-end always has its target.  The JAX package's "orbax"
backend (sharding-aware, multi-host) is not ported.
"""

from __future__ import annotations

import json
import os
import re
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
    eval_loss step is never pruned) and latest / best tracking."""

    def __init__(self, directory: str, save_total_limit: int = 2,
                 backend: str = "npz"):
        if backend == "orbax":
            raise NotImplementedError("the orbax checkpoint backend is a JAX "
                                      "library; the port writes npz")
        if backend != "npz":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.directory = directory
        self.save_total_limit = save_total_limit
        self.backend = backend
        os.makedirs(directory, exist_ok=True)

    # paths -----------------------------------------------------------------
    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def _meta_path(self, step: int) -> str:
        return self._step_path(step) + ".meta.json"

    def _step_paths(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)\.npz$", name)
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
        host: the next in-place step may start once this returns)."""
        path = self._step_path(step)
        save_pytree_npz(path, convert.train_state_to_jax(state))
        with open(self._meta_path(step), "w") as f:
            json.dump({"step": step, "metrics": metrics or {}}, f)
        self._prune()
        return path

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
        state = convert.train_state_from_jax(load_pytree_npz(path), state)
        return state, self._meta(path)
