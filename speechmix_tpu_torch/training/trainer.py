"""The train step (port of ``speechmix_tpu.training.trainer``): AdamW with
warmup and decay, gradient accumulation over micro-batches, the variant's
static freezing mask, clipping by global norm, and with ``dropout=True``
(the default) training-mode dropout, SpecAugment and LayerDrop at the
models' rates.

Parameters are float32 master weights; ``TrainConfig.bf16`` selects the
compute dtype, and the kernels' differentiable forms hand each weight its
gradient in float32.  ``step_fn`` updates the parameters and the optimizer
moments in place (the JAX package returns new arrays and donates the old).

The dropout keys are host integers, chained as the JAX package chains its
rng: base = key(seed + 0x5EED), then fold_in(step), then one split per
micro-batch (``dropout_keys``).  A step is deterministic per (seed, step,
micro-batch); its streams differ from the JAX package's.

Not ported yet, and refused with NotImplementedError: Adafactor, gradual
unfreezing (``freeze_epochs > 0``), model / sequence parallelism and ZeRO-1.
``Trainer.fit``, evaluation, logging and checkpoints wait as well.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..config import SpeechMixConfig
from ..models import speechmix as smx
from ..ops.kernels._cuda import resolve_device
from ..ops.kernels.dropout import DropoutKey
from . import freezing
from .freezing import tree_map, tree_map_with_path, tree_paths

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainConfig:
    """The fields of the JAX package's TrainConfig that the train step reads,
    with its defaults."""
    learning_rate: float = 4e-5
    warmup_steps: int = 500
    lr_schedule: str = "linear"  # "linear" | "cosine" | "constant"
    max_grad_norm: float = 10.0
    grad_accum: int = 1
    max_steps: int = 0  # 0 = no cap: the schedule stays constant after warmup
    bf16: bool = False  # compute dtype
    seed: int = 0       # of the dropout key chain
    dropout: bool = True
    optimizer: str = "adafactor"
    freeze_epochs: int = 0
    model_parallel: int = 1
    sequence_parallel: int = 1
    zero1: bool = False
    fixed_speech: bool = False
    fixed_nlp: bool = True


class TrainState(NamedTuple):
    params: Any      # float32 master weights
    opt_state: Any   # {"mu", "nu": trees like params, "count": int}
    step: int


def _check_supported(tc: TrainConfig):
    if tc.optimizer == "adafactor":
        raise NotImplementedError("Adafactor is not ported yet; set "
                                  "optimizer='adamw'")
    if tc.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tc.optimizer!r} (expected "
                         "'adafactor' or 'adamw')")
    if tc.freeze_epochs > 0:
        raise NotImplementedError("gradual unfreezing is not ported yet; "
                                  "set freeze_epochs=0")
    if tc.model_parallel > 1 or tc.sequence_parallel > 1 or tc.zero1:
        raise NotImplementedError("model / sequence parallelism and ZeRO-1 "
                                  "are not ported yet")


def make_lr_schedule(tc: TrainConfig):
    """count -> learning rate: linear warmup from 0 over warmup_steps, then
    linear decay to 0 or cosine decay over max_steps - warmup_steps, or a
    constant rate (also when max_steps is 0).  Counts start at 0, so with a
    warmup the first update has rate 0."""
    decay_steps = max(tc.max_steps - tc.warmup_steps, 1)
    lr = tc.learning_rate

    def tail(count):
        frac = min(max(count / decay_steps, 0.0), 1.0)
        if tc.lr_schedule == "linear" and tc.max_steps > 0:
            return lr * (1.0 - frac)
        if tc.lr_schedule == "cosine" and tc.max_steps > 0:
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr

    def schedule(count):
        if count < tc.warmup_steps:
            return lr * count / tc.warmup_steps
        return tail(count - tc.warmup_steps)
    return schedule


class AdamW:
    """Clipping by global norm, then AdamW(b1 0.9, b2 0.999, eps 1e-8, weight
    decay 0) at the schedule's rate; the update of optax's
    chain(clip_by_global_norm, adamw)."""

    def __init__(self, tc: TrainConfig):
        self.schedule = make_lr_schedule(tc)
        self.max_norm = tc.max_grad_norm

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update_(self, params, grads, opt_state, grad_norm):
        """One update in place; `grad_norm` is the gradients' global norm.
        Returns the new optimizer state (the same moment tensors)."""
        leaves = lambda tree: [leaf for _, leaf in tree_paths(tree)]
        p, g = leaves(params), leaves(grads)
        mu, nu = leaves(opt_state["mu"]), leaves(opt_state["nu"])
        # g * max_norm / max(norm, max_norm)
        clip = self.max_norm / torch.clamp(grad_norm, min=self.max_norm)
        g = torch._foreach_mul(g, clip)
        count = opt_state["count"] + 1
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, 1.0 - ADAM_B2 ** count))
        torch._foreach_add_(denom, ADAM_EPS)
        lr = self.schedule(opt_state["count"])
        torch._foreach_addcdiv_(p, mu, denom,
                                value=-lr / (1.0 - ADAM_B1 ** count))
        return {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}


def make_optimizer(tc: TrainConfig) -> AdamW:
    _check_supported(tc)
    return AdamW(tc)


def create_train_state(generator: torch.Generator, cfg: SpeechMixConfig,
                       tc: TrainConfig, device=None) -> TrainState:
    """Random float32 parameters drawn from `generator` (on `device`, by
    default the card) and empty optimizer moments."""
    device = resolve_device(device)
    params = smx.init_speechmix(cfg, generator, device, torch.float32)
    return TrainState(params, make_optimizer(tc).init(params), 0)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, a 0-d float32 tensor."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(leaves)))


def dropout_keys(tc: TrainConfig, step: int):
    """The dropout key of each micro-batch of step `step` (counted from 0),
    or Nones with dropout off: the JAX package's chain
    split(fold_in(PRNGKey(seed + 0x5EED), step), grad_accum) on host keys."""
    if not tc.dropout:
        return [None] * tc.grad_accum
    base = DropoutKey.from_seed(tc.seed + 0x5EED)
    return base.fold_in(step).split(tc.grad_accum)


def make_train_step(cfg: SpeechMixConfig, tc: TrainConfig, params_example,
                    device=None):
    """Build step_fn(state, batch) -> (state, metrics).

    batch: dict of tensors or arrays with leading size grad_accum * micro_b:
    input_values (waveforms), labels (-100 = ignored), and optionally
    lengths, prompt_ids and example_mask (rows that are False are filler and
    leave the loss).  The step takes the gradient of each micro-batch's mean
    loss, averages over the grad_accum micro-batches, applies the variant's
    static mask, clips by global norm and updates.  metrics: "loss" (mean
    over micro-batches) and "grad_norm" (after the mask, before clipping),
    0-d tensors on the device, and "layers_skipped", the speech-encoder
    layers LayerDrop skipped in each micro-batch (host lists).

    Runs on `device` (default: the card; raises without CUDA); the state
    must live there.  The parameters and moments of `state` are updated in
    place."""
    _check_supported(tc)
    smx._check_supported(cfg)
    device = resolve_device(device)
    optimizer = AdamW(tc)
    dtype = torch.bfloat16 if tc.bf16 else torch.float32
    static_mask = freezing.variant_trainable_mask(
        params_example, cfg, tc.fixed_speech, tc.fixed_nlp)
    accum = tc.grad_accum

    def micro_loss(params, micro, key):
        labels = micro["labels"]
        if "example_mask" in micro:
            labels = torch.where(micro["example_mask"][:, None].bool(),
                                 labels, -100)
        out = smx.speechmix_forward(
            params, cfg, micro["input_values"], lengths=micro.get("lengths"),
            labels=labels, prompt_ids=micro.get("prompt_ids"), dtype=dtype,
            dropout_rng=key)
        return out["loss"], out["layers_skipped"]

    def step_fn(state: TrainState, batch):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        # a frozen parameter needs no gradient: its masked gradient is 0
        leaves = tree_map(
            lambda p, m: p.detach().requires_grad_(m > 0), state.params,
            static_mask)
        wanted = [(path, leaf) for path, leaf in tree_paths(leaves)
                  if leaf.requires_grad]
        sums = {path: torch.zeros_like(leaf, dtype=torch.float32)
                for path, leaf in wanted}
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        skipped = []
        for i, key in enumerate(dropout_keys(tc, state.step)):
            micro = {k: v.reshape(accum, v.shape[0] // accum,
                                  *v.shape[1:])[i] for k, v in batch.items()}
            loss, layers_skipped = micro_loss(leaves, micro, key)
            skipped.append(layers_skipped)
            grads = torch.autograd.grad(loss, [leaf for _, leaf in wanted],
                                        allow_unused=True)
            for (path, _), g in zip(wanted, grads):
                if g is not None:
                    sums[path] += g
            loss_sum += loss.detach().float()
        grads = tree_map_with_path(
            lambda path, p: (sums[path] / accum if path in sums else
                             torch.zeros_like(p, dtype=torch.float32)),
            state.params)
        grads = freezing.apply_grad_mask(grads, static_mask)
        grad_norm = global_norm(grads)
        opt_state = optimizer.update_(state.params, grads, state.opt_state,
                                      grad_norm)
        metrics = {"loss": loss_sum / accum, "grad_norm": grad_norm,
                   "layers_skipped": skipped}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step_fn
