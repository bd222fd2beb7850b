"""The train step (port of ``speechmix_tpu.training.trainer``): Adafactor
(the default, the reference's recipe) or AdamW with warmup and decay,
gradient accumulation over micro-batches, the variant's static freezing
mask, gradual unfreezing of the speech encoder, the GAN's alternating
generator / discriminator masks, clipping by global norm, and with
``dropout=True`` (the default) training-mode dropout, SpecAugment and
LayerDrop at the models' rates.

Parameters are float32 master weights; ``TrainConfig.bf16`` selects the
compute dtype, and the kernels' differentiable forms hand each weight its
gradient in float32.  ``step_fn`` updates the parameters and the optimizer
state in place (the JAX package returns new arrays and donates the old).

The dropout keys are host integers, chained as the JAX package chains its
rng: base = key(seed + 0x5EED), then fold_in(step), then one split per
micro-batch (``dropout_keys``).  A step is deterministic per (seed, step,
micro-batch); its streams differ from the JAX package's.

Not ported yet, and refused with NotImplementedError: model / sequence
parallelism and ZeRO-1.  ``Trainer.fit``, evaluation, logging and
checkpoints wait as well.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import convert
from ..config import SpeechMixConfig
from ..models import speechmix as smx
from ..ops.kernels._cuda import resolve_device
from ..ops.kernels.dropout import DropoutKey
from . import freezing
from .freezing import tree_map, tree_map_with_path, tree_paths

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# optax.adafactor's defaults under the JAX package's recipe
# (multiply_by_parameter_scale=False, min_dim_size_to_factor=0)
ADAFACTOR_DECAY, ADAFACTOR_EPS, ADAFACTOR_CLIP = 0.8, 1e-30, 1.0


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
    # "tensor": the reference's FreezingCallback, tensor by tensor
    # (freezing.reference_unfreeze_scale); "layer": whole layers
    # (freezing.gradual_unfreeze_scale)
    unfreeze_granularity: str = "tensor"
    model_parallel: int = 1
    sequence_parallel: int = 1
    zero1: bool = False
    fixed_speech: bool = False
    fixed_nlp: bool = True


class TrainState(NamedTuple):
    params: Any      # float32 master weights
    # AdamW: {"mu", "nu": trees like params, "count": int}; Adafactor:
    # {"v_row", "v_col", "v": trees in the JAX package's layout, "count"}
    opt_state: Any
    step: int


def _check_supported(tc: TrainConfig):
    if tc.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tc.optimizer!r} (expected "
                         "'adafactor' or 'adamw')")
    if tc.unfreeze_granularity not in ("tensor", "layer"):
        raise ValueError(f"unknown unfreeze_granularity "
                         f"{tc.unfreeze_granularity!r} (expected 'tensor' "
                         "or 'layer')")
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


def _factored_dims(shape):
    """optax's choice of the two axes a second moment is factored over (its
    _factored_dims with min_dim_size_to_factor=0): (the second largest, the
    largest) by np.argsort of the leaf's shape in the JAX layout, or None
    for a vector."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    return int(order[-2]), int(order[-1])


class Adafactor:
    """Clipping by global norm, then Adafactor: the update of optax's
    chain(clip_by_global_norm(max_grad_norm), adafactor(schedule,
    multiply_by_parameter_scale=False, min_dim_size_to_factor=0)).  In order:
    the second moment's factored estimate (decay 1 - (count + 1)^-0.8,
    eps 1e-30 added to g^2), the gradient scaled by its inverse square root,
    clipped to block RMS 1, times the schedule's rate, sign flipped.

    optax works leaf by leaf on the JAX package's tree, so this does too:
    the statistics, the factored axes (np.argsort of the JAX shape) and the
    block RMS belong to the leaves of ``convert.jax_layout_groups``, where a
    layer list is one stacked leaf (a stacked vector (L, n) is factored
    across its layers; a stacked matrix keeps per-layer row and column
    statistics but is clipped as a whole) and a conv kernel is (K, C_in,
    C_out).  Every leaf's statistics move every step, also where the
    gradient is 0 (a frozen leaf), as optax's do."""

    def __init__(self, tc: TrainConfig):
        self.schedule = make_lr_schedule(tc)
        self.max_norm = tc.max_grad_norm

    def init(self, params):
        def stats(group):
            zeros = lambda shape: torch.zeros(
                shape, dtype=torch.float32, device=group.tensors[0].device)
            shape = group.shape
            dims = _factored_dims(shape)
            if dims is None:
                return zeros(1), zeros(1), zeros(shape)
            d1, d0 = dims
            return (zeros(np.delete(shape, d0).tolist()),
                    zeros(np.delete(shape, d1).tolist()), zeros(1))
        groups = convert.jax_layout_groups(params)
        return {"v_row": tree_map(lambda g: stats(g)[0], groups),
                "v_col": tree_map(lambda g: stats(g)[1], groups),
                "v": tree_map(lambda g: stats(g)[2], groups), "count": 0}

    @torch.no_grad()
    def update_(self, params, grads, opt_state, grad_norm):
        """One update in place; `grad_norm` is the gradients' global norm.
        Returns the new optimizer state (the same statistics tensors)."""
        leaves = lambda tree: [leaf for _, leaf in tree_paths(tree)]
        p_groups = leaves(convert.jax_layout_groups(params))
        g_groups = leaves(convert.jax_layout_groups(grads))
        v_rows, v_cols, vs = (leaves(opt_state[k])
                              for k in ("v_row", "v_col", "v"))
        count = opt_state["count"]
        # in float32, as optax computes it
        decay = float(np.float32(1.0) - np.float32(count + 1)
                      ** np.float32(-ADAFACTOR_DECAY))
        lr = self.schedule(count)
        clipped = grad_norm >= self.max_norm
        targets, updates = [], []
        for pg, gg, v_row, v_col, v in zip(p_groups, g_groups, v_rows,
                                           v_cols, vs):
            g = gg.gather().float()
            g = torch.where(clipped, g / grad_norm * self.max_norm, g)
            g2 = g * g + ADAFACTOR_EPS
            dims = _factored_dims(pg.shape)
            if dims is None:
                v.mul_(decay).add_(g2, alpha=1.0 - decay)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row.mul_(decay).add_(g2.mean(d0), alpha=1.0 - decay)
                v_col.mul_(decay).add_(g2.mean(d1), alpha=1.0 - decay)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(reduced_d1, keepdim=True)).pow(-0.5)
                u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            rms = torch.sqrt(torch.mean(u * u)) / ADAFACTOR_CLIP
            u = u / torch.clamp_min(rms, 1.0) * -lr
            targets += pg.tensors
            updates += pg.views(u)
        torch._foreach_add_(targets, updates)
        return {**opt_state, "count": count + 1}


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(tc: TrainConfig):
    _check_supported(tc)
    return OPTIMIZERS[tc.optimizer](tc)


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
    """Build step_fn(state, batch, unfreeze_progress=0.0) -> (state,
    metrics).

    batch: dict of tensors or arrays with leading size grad_accum * micro_b:
    input_values (waveforms), labels (-100 = ignored), and optionally
    lengths, prompt_ids, text_input_ids and text_mask (the self and gan
    variants' text pass) and example_mask (rows that are False are filler
    and leave the loss).  The step takes the gradient of each micro-batch's
    mean loss and averages over the grad_accum micro-batches.  Then, as the
    JAX package's step, it multiplies in the variant's static mask, with
    freeze_epochs > 0 the unfreezing mask at `unfreeze_progress` (epoch /
    freeze_epochs; tensor or layer granularity), for gan the alternating
    mask of state.step, clips by global norm and updates.  A leaf the masks
    freeze gets no gradient computed, only a zero one.  metrics: "loss"
    (mean over micro-batches), "grad_norm" (after the masks, before
    clipping) and the variant's named loss terms (self: ce_loss, kld_loss,
    mse_loss; gan: voice_enc_loss, ...), 0-d tensors on the device, and
    "layers_skipped", the speech-encoder layers LayerDrop skipped in each
    micro-batch (host lists).

    Runs on `device` (default: the card; raises without CUDA); the state
    must live there.  The parameters and the optimizer state of `state` are
    updated in place."""
    _check_supported(tc)
    smx._check_supported(cfg)
    device = resolve_device(device)
    optimizer = make_optimizer(tc)
    dtype = torch.bfloat16 if tc.bf16 else torch.float32
    static_mask = freezing.variant_trainable_mask(
        params_example, cfg, tc.fixed_speech, tc.fixed_nlp)
    accum = tc.grad_accum

    def step_mask(params, step, progress):
        """The product of the step's masks: one 0.0 or 1.0 per leaf."""
        masks = [static_mask]
        if tc.freeze_epochs > 0:
            if tc.unfreeze_granularity == "tensor":
                masks.append(freezing.reference_unfreeze_scale(
                    params, freezing.unfreeze_epoch(progress,
                                                    tc.freeze_epochs),
                    tc.freeze_epochs))
            else:
                masks.append(freezing.gradual_unfreeze_scale(params,
                                                             progress))
        if cfg.variant == "gan":
            masks.append(freezing.gan_alternating_masks(
                params, step, cfg.gan_discriminator_update_every))
        return tree_map(lambda *m: math.prod(m), *masks)

    def micro_forward(params, micro, key):
        labels = micro["labels"]
        if "example_mask" in micro:
            labels = torch.where(micro["example_mask"][:, None].bool(),
                                 labels, -100)
        out = smx.speechmix_forward(
            params, cfg, micro["input_values"], lengths=micro.get("lengths"),
            labels=labels, prompt_ids=micro.get("prompt_ids"), dtype=dtype,
            dropout_rng=key, text_input_ids=micro.get("text_input_ids"),
            text_mask=micro.get("text_mask"))
        return out

    def step_fn(state: TrainState, batch, unfreeze_progress=0.0):
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        mask = step_mask(state.params, state.step, unfreeze_progress)
        leaves = tree_map(
            lambda p, m: p.detach().requires_grad_(m > 0), state.params,
            mask)
        wanted = [(path, leaf) for path, leaf in tree_paths(leaves)
                  if leaf.requires_grad]
        sums = {path: torch.zeros_like(leaf, dtype=torch.float32)
                for path, leaf in wanted}
        terms = {}
        skipped = []
        for i, key in enumerate(dropout_keys(tc, state.step)):
            micro = {k: v.reshape(accum, v.shape[0] // accum,
                                  *v.shape[1:])[i] for k, v in batch.items()}
            out = micro_forward(leaves, micro, key)
            skipped.append(out["layers_skipped"])
            if wanted and out["loss"].requires_grad:
                grads = torch.autograd.grad(
                    out["loss"], [leaf for _, leaf in wanted],
                    allow_unused=True)
                for (path, _), g in zip(wanted, grads):
                    if g is not None:
                        sums[path] += g
            for name, value in out.items():
                if name == "loss" or name.endswith("_loss"):
                    terms[name] = (terms.get(name, 0.0)
                                   + value.detach().float())
        # the masks are 0.0 or 1.0 per leaf: a frozen leaf's masked gradient
        # is the zero it gets here, a trained leaf's its own
        grads = tree_map_with_path(
            lambda path, p: (sums[path] / accum if path in sums else
                             torch.zeros_like(p, dtype=torch.float32)),
            state.params)
        grad_norm = global_norm(grads)
        opt_state = optimizer.update_(state.params, grads, state.opt_state,
                                      grad_norm)
        metrics = {**{name: value / accum for name, value in terms.items()},
                   "grad_norm": grad_norm, "layers_skipped": skipped}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step_fn
