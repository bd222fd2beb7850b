"""The reference's first training steps: the recipe of ``optim`` over the
loss of ``model.forward_loss``, from the same weights, batches and dropout
keys as the run, in float32 (or a control's precision), each layer
rematerialised so that the largest configuration fits.

Returns what the run's numbers are compared with: each step's loss, each
leaf's first gradient norm as the optimizer takes it (after clipping), and
each leaf's change over the steps.
"""

from __future__ import annotations

import torch

from . import model, optim
from .keys import step_key
from .precision import Precision


def run_steps(params, cfg, batches, seed, recipe, precision="f32"):
    """params: the weights (float32; updated in place); batches: dicts with
    input_values, lengths, labels, one per step; seed: the dropout key
    chain's; recipe: {"learning_rate", "warmup_steps", "max_grad_norm"}.
    Returns {"loss": [per step], "grad_norm": {leaf: norm of step 1},
    "delta_norm": {leaf: norm of the change}, "skipped": [per step]}."""
    P = Precision(precision)
    start = {n: [t.detach().clone() for t in ts]
             for n, ts, _, _ in optim.groups(params)}
    leaves = {n: (ts, c, s) for n, ts, c, s in optim.groups(params)}
    opt = optim.Adafactor(recipe["learning_rate"], recipe["warmup_steps"],
                          recipe["max_grad_norm"])
    losses, skipped, first = [], [], None
    for step, batch in enumerate(batches):
        flat = [t for ts, _, _ in leaves.values() for t in ts]
        for t in flat:
            t.requires_grad_(True)
        loss, skips = model.forward_loss(
            params, cfg, batch["input_values"], batch["lengths"],
            batch["labels"], step_key(seed, step), P)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        for t in flat:
            t.requires_grad_(False)
        losses.append(float(loss.detach()))
        skipped.append(skips)
        it = iter(grads)
        jax_grads = {}
        for name, (ts, conv, stacked) in leaves.items():
            gs = [next(it) for _ in ts]
            gs = [torch.zeros_like(t) if g is None else g
                  for g, t in zip(gs, ts)]
            jax_grads[name] = optim.jax_view(gs, conv, stacked)
        del grads, loss
        clipped = opt.step(leaves, jax_grads)
        if first is None:
            first = {n: float(torch.linalg.vector_norm(g))
                     for n, g in clipped.items()}
        del clipped, jax_grads
    delta = {}
    for name, (ts, conv, stacked) in leaves.items():
        d = optim.jax_view(ts, conv, stacked) - optim.jax_view(
            start[name], conv, stacked)
        delta[name] = float(torch.linalg.vector_norm(d))
    return {"loss": losses, "grad_norm": first, "delta_norm": delta,
            "skipped": skipped}
