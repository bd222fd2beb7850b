"""The train step and the loop around it (port of
``speechmix_tpu.training.trainer``): Adafactor
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

Over a mesh (``parallel.mesh``; ``make_train_step(..., mesh=)``,
``Trainer(..., mesh=)``) each rank holds its share of the parameters
(``mesh.shard_params``) and its data rank's rows of each batch
(``mesh.local_batch``, or the multihost data path); the step sums the
gradients over their groups, takes the global norm, and with ``zero1``
keeps and updates only the optimizer state this data rank owns, then
broadcasts the updated parameters (``training.sharded``).  Without a mesh ``model_parallel``,
``sequence_parallel`` and ``zero1`` change nothing, as the JAX package's
step without a mesh.

``Trainer`` runs the loop as the JAX package's does: epochs that feed
``epoch / freeze_epochs`` to the step, batches staged on the card ahead of
the step (``data.prefetch``), JSONL logging, teacher-forced ``evaluate``
(``make_eval_step``) and free-running ``predict`` (greedy or beam
``generate`` with WER / CER) every ``eval_steps``, early stopping,
checkpoints (``training.checkpoint``: the JAX package's npz files, or the
port's sharded ``orbax`` counterpart; resume from the latest, keep the
best, restore it at the end) and a stall watchdog.  As in the JAX package,
a resumed run starts its epoch again from the first batch.  Over a mesh
every rank computes the same metrics (evaluate and predict gather the rows
of all data ranks) and so makes the same early-stopping decision; only
rank 0 logs and writes npz files.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from .. import convert, generation
from ..config import SpeechMixConfig
from ..data.prefetch import _as_tensor, prefetch_to_device
from ..metrics import cer, compute_metrics, wer
from ..models import speechmix as smx
from ..ops.kernels._cuda import resolve_device
from ..ops.kernels.dropout import DropoutKey
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from ..utils import profiling
from ..utils import watchdog as watchdog_lib
from . import freezing
from . import sharded
from .checkpoint import CheckpointManager
from .freezing import tree_map, tree_map_with_path, tree_paths

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# optax.adafactor's defaults under the JAX package's recipe
# (multiply_by_parameter_scale=False, min_dim_size_to_factor=0)
ADAFACTOR_DECAY, ADAFACTOR_EPS, ADAFACTOR_CLIP = 0.8, 1e-30, 1.0


@dataclass
class TrainConfig:
    """The JAX package's TrainConfig with its defaults (its ``use_flash``
    aside: the port has no attention toggle)."""
    learning_rate: float = 4e-5
    warmup_steps: int = 500
    lr_schedule: str = "linear"  # "linear" | "cosine" | "constant"
    max_grad_norm: float = 10.0
    grad_accum: int = 1
    num_epochs: int = 10
    eval_steps: int = 700
    logging_steps: int = 10
    save_total_limit: int = 2
    early_stopping_patience: int = 20
    # restore the best-eval_loss checkpoint when training ends (the
    # reference's load_best_model_at_end=True)
    load_best_model_at_end: bool = True
    max_steps: int = 0  # 0 = no cap: the schedule stays constant after warmup
    # also run free-running generate() + WER / CER at each eval
    predict_with_generate: bool = False
    num_beams: int = 1  # beams of predict_with_generate's decoding
    output_dir: str = "./checkpoints"
    # "npz": the JAX package's files; "orbax": the port's sharded files
    # (torch.distributed.checkpoint), each rank its own shards
    checkpoint_backend: str = "npz"
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
    wandb: bool = False  # mirror the metrics to wandb when it is installed
    fixed_speech: bool = False
    fixed_nlp: bool = True
    # abort (exit 98) if the loop sends no heartbeat for this many seconds,
    # so that a supervisor can relaunch and resume; 0 = off
    stall_timeout_s: float = 0.0
    # batches staged on the device this many steps ahead by a host thread
    # (data/prefetch.py); 0 = synchronous
    prefetch_depth: int = 2


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

    def __init__(self, tc: TrainConfig, layout=None):
        self.tc = tc
        self.schedule = make_lr_schedule(tc)
        self.max_norm = tc.max_grad_norm
        self.layout = layout   # training.sharded.StepLayout (ZeRO-1)

    def init(self, params):
        """Zero moments (under ZeRO-1 only for the leaves this data rank
        owns; None for the others)."""
        mine = self.layout.mine if self.layout is not None else None
        zeros = lambda p: (torch.zeros_like(p, dtype=torch.float32)
                           if mine is None or mine(p) else None)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update_(self, params, grads, opt_state, grad_norm):
        """One update in place; `grad_norm` is the gradients' global norm.
        Returns the new optimizer state (the same moment tensors)."""
        leaves = lambda tree: [leaf for _, leaf in tree_paths(tree)]
        p, g = leaves(params), leaves(grads)
        mu, nu = leaves(opt_state["mu"]), leaves(opt_state["nu"])
        if self.layout is not None:  # the leaves this data rank owns
            own = [i for i, m in enumerate(mu) if m is not None]
            p, g, mu, nu = ([x[i] for i in own] for x in (p, g, mu, nu))
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

    def __init__(self, tc: TrainConfig, layout=None):
        self.tc = tc
        self.schedule = make_lr_schedule(tc)
        self.max_norm = tc.max_grad_norm
        # training.sharded.StepLayout: ZeRO-1 ownership and the model dim
        # of each leaf (statistics of the whole leaf)
        self.layout = layout

    def _shape(self, group):
        return (group.shape if self.layout is None
                else self.layout.global_shape(group))

    def init(self, params):
        """Zero statistics of each JAX-layout leaf (under ZeRO-1 only of
        the leaves this data rank owns; None for the others)."""
        def stats(group):
            if self.layout is not None and \
                    not self.layout.mine(group.tensors[0]):
                return None, None, None
            zeros = lambda shape: torch.zeros(
                shape, dtype=torch.float32, device=group.tensors[0].device)
            shape = self._shape(group)
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
        layout = self.layout
        for pg, gg, v_row, v_col, v in zip(p_groups, g_groups, v_rows,
                                           v_cols, vs):
            if v is None:   # another data rank owns this leaf
                continue
            g = gg.gather().float()
            dim = layout.group_dim(pg) if layout is not None else None
            if dim is not None:   # the whole leaf from its model shares
                g = collectives.all_gather(
                    g.contiguous(), layout.mesh.group("model"), dim=dim)
            g = torch.where(clipped, g / grad_norm * self.max_norm, g)
            g2 = g * g + ADAFACTOR_EPS
            dims = _factored_dims(self._shape(pg))
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
            if dim is not None:
                size = u.shape[dim] // layout.mesh.n_model
                u = u.narrow(dim, layout.mesh.model_rank * size, size)
            targets += pg.tensors
            updates += pg.views(u)
        torch._foreach_add_(targets, updates)
        return {**opt_state, "count": count + 1}


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(tc: TrainConfig, layout=None):
    _check_supported(tc)
    return OPTIMIZERS[tc.optimizer](tc, layout)


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
                    device=None, mesh=None):
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
    updated in place.

    mesh: a ``parallel.mesh.Mesh``; then `params_example` and the state are
    this rank's shares (``shard_train_state``), the batch is this data
    rank's rows (``mesh.local_batch`` with ``accum=grad_accum``), the
    device is the mesh's, and the metrics are the global batch's (the same
    on every rank).  Sequence parallelism runs when tc.sequence_parallel >
    1 and the mesh's seq axis is parallel; ZeRO-1 when tc.zero1.

    ``step_fn.gradients(state, batch, unfreeze_progress)`` gives the step's
    (grads, grad_norm, metrics) without the update; ``step_fn.layout`` is
    the mesh plan (``training.sharded.StepLayout``, None without a mesh)."""
    _check_supported(tc)
    layout = None
    if mesh is not None:
        device = mesh.device
        layout = sharded.StepLayout(mesh, cfg, params_example, tc.optimizer,
                                    tc.zero1, tc.sequence_parallel > 1)
    device = resolve_device(device)
    optimizer = make_optimizer(tc, layout)
    seq_mesh = mesh if layout is not None and layout.seq_parallel else None
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
        with profiling.annotate("train_step.forward"):
            return smx.speechmix_forward(
                params, cfg, micro["input_values"],
                lengths=micro.get("lengths"), labels=labels,
                prompt_ids=micro.get("prompt_ids"), dtype=dtype,
                dropout_rng=key, text_input_ids=micro.get("text_input_ids"),
                text_mask=micro.get("text_mask"))

    def gradients(state: TrainState, batch, unfreeze_progress=0.0):
        """(grads, grad_norm, metrics) of the step without the update: the
        masked gradients averaged over the micro-batches (over a mesh
        summed over their groups: this rank's shares of the whole tree's),
        their global norm, and the metrics without grad_norm."""
        # train_step.leaves: the step's host work over every leaf outside
        # the forward, the backward and the update, here and after the
        # loop; thousands of host ops for a large tree while the card idles
        with profiling.annotate("train_step.leaves"):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
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
        # the mesh stays active through the backward: a rematerialised
        # layer runs its forward again there
        with mesh_lib.tp_sharding(mesh), mesh_lib.seq_sharding(seq_mesh):
            for i, key in enumerate(dropout_keys(tc, state.step)):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                out = micro_forward(leaves, micro, key)
                skipped.append(out["layers_skipped"])
                if wanted and out["loss"].requires_grad:
                    with profiling.annotate("train_step.backward"):
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
        with profiling.annotate("train_step.leaves"):
            if layout is not None:
                sums = tree_map_with_path(
                    lambda path, p: sums.get(path, torch.zeros_like(
                        p, dtype=torch.float32)), state.params)
                sharded.reduce_gradients(sums, layout)
                grads = tree_map(lambda g: g / accum, sums)
                grad_norm = sharded.global_norm(grads, layout)
                terms = {name: collectives.all_reduce(
                    value.clone(), mesh.group(mesh_lib.DATA_AXIS))
                    for name, value in terms.items()}
            else:
                grads = tree_map_with_path(
                    lambda path, p: (sums[path] / accum if path in sums else
                                     torch.zeros_like(p, dtype=torch.float32)),
                    state.params)
                grad_norm = global_norm(grads)
            # released inside the span: thousands of tensors, milliseconds
            # of host time while the card idles
            del sums, leaves, wanted, out
        metrics = {**{name: value / accum for name, value in terms.items()},
                   "layers_skipped": skipped}
        return grads, grad_norm, metrics

    def step_fn(state: TrainState, batch, unfreeze_progress=0.0):
        with profiling.annotate("train_step", root=True):
            grads, grad_norm, metrics = gradients(state, batch,
                                                  unfreeze_progress)
            with profiling.annotate("train_step.optimizer"):
                opt_state = optimizer.update_(state.params, grads,
                                              state.opt_state, grad_norm)
                if layout is not None:
                    sharded.broadcast_updates(state.params, layout)
        metrics = {**metrics, "grad_norm": grad_norm}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    step_fn.layout = layout
    step_fn.gradients = gradients
    return step_fn


def shard_train_state(state: TrainState, mesh, cfg: SpeechMixConfig,
                      tc: TrainConfig) -> TrainState:
    """This rank's share of a one-card TrainState `state` (on any device):
    its parameters' model shares (``mesh.shard_params``) on the mesh's
    device, and the optimizer state of make_train_step(..., mesh=)'s layout
    (under ZeRO-1 only the leaves this data rank owns), copied from
    `state`'s."""
    params = mesh_lib.shard_params(
        mesh, tree_map(lambda t: t.to(mesh.device), state.params), cfg)
    layout = sharded.StepLayout(mesh, cfg, params, tc.optimizer, tc.zero1,
                                tc.sequence_parallel > 1)
    local = TrainState(params, make_optimizer(tc, layout).init(params),
                       state.step)
    return sharded.load_full_state(local, state, layout)


def _to_device(batch, device):
    return {k: _as_tensor(v).to(device) for k, v in batch.items()}


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def make_eval_step(cfg: SpeechMixConfig, tc: TrainConfig, device=None,
                   mesh=None):
    """Build eval_fn(params, batch) -> {"loss", "predictions", "n_tokens",
    "n_examples"}: the teacher-forced forward without dropout and without a
    gradient, the argmax predictions, the count of label tokens (a batch
    without any has a NaN-free mean loss of 0, which evaluate() leaves out)
    and of real rows (``example_mask``), which weight evaluate()'s mean as
    the reference's Trainer weights it.  Runs on `device` (default: the
    card; raises without CUDA).  Over a mesh (tensor parallel, no sequence
    split, as the JAX package's eval step) the loss and the counts are the
    global batch's, the predictions this data rank's rows."""
    device = mesh.device if mesh is not None else resolve_device(device)
    dtype = torch.bfloat16 if tc.bf16 else torch.float32
    group = mesh.group(mesh_lib.DATA_AXIS) if mesh is not None else None

    @torch.no_grad()
    def eval_fn(params, batch):
        batch = _to_device(batch, device)
        labels = batch["labels"]
        if "example_mask" in batch:
            labels = torch.where(batch["example_mask"][:, None].bool(),
                                 labels, -100)
        with mesh_lib.tp_sharding(mesh):
            out = smx.speechmix_forward(
                params, cfg, batch["input_values"],
                lengths=batch.get("lengths"), labels=labels,
                prompt_ids=batch.get("prompt_ids"), dtype=dtype,
                text_input_ids=batch.get("text_input_ids"),
                text_mask=batch.get("text_mask"))
        n_ex = (batch["example_mask"].sum() if "example_mask" in batch
                else labels.shape[0])
        n_tokens = (labels != -100).sum()
        loss = out["loss"]
        if group is not None:
            loss, n_ex, n_tokens = (
                collectives.all_reduce(torch.as_tensor(v, device=device)
                                       .clone(), group)
                for v in (loss, n_ex, n_tokens))
        return {"loss": loss,
                "predictions": torch.argmax(out["logits"], dim=-1),
                "n_tokens": n_tokens, "n_examples": n_ex}

    return eval_fn


class JSONLLogger:
    """Metrics logger: JSON lines in `path` (if given), echoed to stdout;
    with use_wandb also mirrored to wandb when the package is installed
    (project from WANDB_PROJECT), else JSONL only."""

    def __init__(self, path: Optional[str], use_wandb: bool = False,
                 echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=os.environ.get("WANDB_PROJECT",
                                                      "speechmix_tpu"))
            except Exception:  # no package / no auth / offline: JSONL only
                self._wandb = None

    def log(self, record: dict):
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self._wandb is not None:
            step = record.get("step")
            self._wandb.log(record,
                            step=int(step) if step is not None else None)
        if self.echo:
            print(json.dumps(record))

    def close(self):
        if self._f:
            self._f.close()


class Trainer:
    """The loop around the step functions (epochs, eval, early stopping,
    checkpoints), on `device` (default: the card; raises without CUDA).

    mesh: a ``parallel.mesh.Mesh``; by default, under torch.distributed or
    with model_parallel / sequence_parallel above 1, make_mesh(n_model=
    tc.model_parallel, n_seq=tc.sequence_parallel) over the world, as the
    JAX package builds its mesh; else none (one card).  Over a mesh the
    states fit() takes and returns are this rank's shares
    (``init_state`` / ``shard_train_state``), and the batches each rank's
    rows."""

    def __init__(self, cfg: SpeechMixConfig, tc: TrainConfig, tokenizer=None,
                 device=None, mesh=None):
        _check_supported(tc)
        self.cfg = cfg
        self.tc = tc
        self.tokenizer = tokenizer
        if mesh is None and (mesh_lib.process_count() > 1
                             or tc.model_parallel > 1
                             or tc.sequence_parallel > 1):
            mesh = mesh_lib.make_mesh(n_model=tc.model_parallel,
                                      n_seq=tc.sequence_parallel,
                                      device=device)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.rank0 = mesh is None or mesh.rank == 0
        self.logger = JSONLLogger(os.path.join(tc.output_dir, "metrics.jsonl")
                                  if tc.output_dir and self.rank0 else None,
                                  use_wandb=tc.wandb and self.rank0,
                                  echo=self.rank0)
        self.ckpt = CheckpointManager(tc.output_dir, tc.save_total_limit,
                                      backend=tc.checkpoint_backend,
                                      mesh=mesh) \
            if tc.output_dir else None

    def init_state(self, generator: Optional[torch.Generator] = None):
        """A fresh TrainState drawn from `generator` (default: seeded with
        tc.seed) on the trainer's device; over a mesh this rank's share of
        it (every rank draws the same tree)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(self.tc.seed)
        state = create_train_state(generator, self.cfg, self.tc, self.device)
        if self.mesh is not None:
            state = shard_train_state(state, self.mesh, self.cfg, self.tc)
        return state

    def _barrier(self):
        import torch.distributed as dist
        if self.mesh is not None and self.mesh.distributed:
            dist.barrier()

    def _save(self, step, state, metrics, layout, optimizer):
        """Checkpoint `state`: the port's sharded files (every rank its
        shards), or the JAX package's npz of the whole state, gathered on
        every rank and written by rank 0."""
        if self.ckpt.backend == "orbax" or layout is None:
            self.ckpt.save(step, state, metrics)
        else:
            full = sharded.full_state(state, layout, optimizer)
            if self.rank0:
                self.ckpt.save(step, full, metrics)
        self._barrier()

    def _restore(self, state, step, layout, optimizer):
        """(state, meta) of checkpoint `step` (None: the latest) written
        into `state`'s tensors; (None, None) without one."""
        if self.ckpt.backend == "orbax" or layout is None:
            return self.ckpt.restore(state, step=step)
        template = sharded.full_state(state, layout, optimizer)
        full, meta = self.ckpt.restore(template, step=step)
        if full is None:
            return None, None
        return sharded.load_full_state(state, full, layout), meta

    def fit(self, state: TrainState, train_batches: Callable[[], Iterable],
            eval_batches: Optional[Callable[[], Iterable]] = None,
            resume: bool = True):
        """train_batches / eval_batches: zero-argument callables that return
        a fresh iterator of batch dicts per epoch.  resume=True restores the
        latest checkpoint of output_dir (parameters, optimizer state, step)
        into `state` when there is one.  `state` is updated in place; the
        returned TrainState carries the final step."""
        step_fn = make_train_step(self.cfg, self.tc, state.params,
                                  device=self.device, mesh=self.mesh)
        eval_fn = make_eval_step(self.cfg, self.tc, device=self.device,
                                 mesh=self.mesh)
        # the step's mesh plan, made again here (a layout is a function of
        # the mesh, the config and the state's tensors)
        self._layout = None if self.mesh is None else sharded.StepLayout(
            self.mesh, self.cfg, state.params, self.tc.optimizer,
            self.tc.zero1, self.tc.sequence_parallel > 1)
        self._optimizer = make_optimizer(self.tc, self._layout)
        if resume and self.ckpt is not None and \
                self.ckpt.latest_step() is not None:
            restored, _ = self._restore(state, None, self._layout,
                                        self._optimizer)
            if restored is not None:
                state = restored
                self.logger.log({"resumed_from_step": int(state.step)})

        watchdog = None
        if self.tc.stall_timeout_s > 0:
            watchdog = watchdog_lib.StallWatchdog(self.tc.stall_timeout_s)
            watchdog.log_path = self.logger.path
            watchdog.start()
        try:
            state = self._fit_loop(state, train_batches, eval_batches,
                                   step_fn, eval_fn, watchdog)
        finally:
            if watchdog is not None:
                watchdog.stop()
        if self.tc.load_best_model_at_end and self.ckpt is not None:
            best = self.ckpt.best_step()
            if best is not None and best != int(state.step):
                restored, _ = self._restore(state, best, self._layout,
                                            self._optimizer)
                if restored is not None:
                    state = restored
                    self.logger.log({"loaded_best_model_from_step": best})
        return state

    def _fit_loop(self, state, train_batches, eval_batches, step_fn, eval_fn,
                  watchdog):
        best_metric = float("inf")
        best_step = 0
        patience_left = self.tc.early_stopping_patience
        t0 = time.time()
        step = int(state.step)
        for epoch in range(self.tc.num_epochs):
            progress = (epoch / self.tc.freeze_epochs
                        if self.tc.freeze_epochs > 0 else 1.0)
            if self.tc.prefetch_depth > 0:
                epoch_batches = prefetch_to_device(
                    train_batches(), self.mesh or self.device,
                    self.tc.prefetch_depth)
            else:
                epoch_batches = (_to_device(b, self.device)
                                 for b in train_batches())
            for batch in epoch_batches:
                if watchdog is not None:
                    watchdog.beat()
                state, metrics = step_fn(state, batch, progress)
                step += 1
                # the max_steps exit comes after the eval / save block (the
                # reference Trainer's order): a last step that is an eval
                # step still evaluates and checkpoints
                if step % self.tc.logging_steps == 0:
                    self.logger.log({"step": step, "epoch": epoch,
                                     "loss": metrics["loss"],
                                     "grad_norm": metrics["grad_norm"],
                                     "elapsed": time.time() - t0})
                if eval_batches and step % self.tc.eval_steps == 0:
                    beat = watchdog.beat if watchdog is not None else None
                    eval_metrics = self.evaluate(state.params, eval_fn,
                                                 eval_batches,
                                                 heartbeat=beat)
                    if self.tc.predict_with_generate:
                        eval_metrics.update(self.predict(
                            state.params, eval_batches,
                            num_beams=self.tc.num_beams, heartbeat=beat))
                    self.logger.log({"step": step, **eval_metrics})
                    score = eval_metrics.get("eval_loss", float("inf"))
                    if self.ckpt:
                        # a synchronous host copy, before the next step
                        # updates the parameters in place
                        self._save(step, state, eval_metrics, self._layout,
                                   self._optimizer)
                    if score < best_metric:
                        best_metric, best_step = score, step
                        patience_left = self.tc.early_stopping_patience
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            self.logger.log({"early_stop": True,
                                             "best_step": best_step})
                            return state
                if self.tc.max_steps and step >= self.tc.max_steps:
                    self.logger.log({"step": step, "loss": metrics["loss"],
                                     "max_steps_reached": True})
                    return state
        return state

    def predict(self, params, eval_batches, max_length=None, num_beams=1,
                heartbeat=None, kv_int8=False):
        """Free-running ASR eval: greedy or beam generate() per batch, then
        corpus WER / CER against the label transcripts over the real rows."""
        max_length = max_length or self.cfg.decoder.max_length
        dtype = torch.bfloat16 if self.tc.bf16 else torch.float32
        refs, hyps = [], []
        mesh = self.mesh
        rows = lambda x: mesh_lib.allgather_rows(_host(x), mesh)
        for batch in eval_batches():
            if heartbeat is not None:
                heartbeat()
            with mesh_lib.tp_sharding(mesh):
                tokens, _ = generation.generate(
                    params, self.cfg, _as_tensor(batch["input_values"]),
                    _as_tensor(batch["lengths"]), max_length=max_length,
                    num_beams=num_beams, kv_int8=kv_int8, dtype=dtype,
                    device=self.device)
            # every data rank's rows, the same on every rank
            tokens = rows(mesh_lib.local_rows(tokens))
            labels = rows(batch["labels"])
            real = batch.get("example_mask")
            real = (np.ones(len(tokens), bool) if real is None
                    else rows(real))
            for i in range(len(tokens)):
                if not real[i]:
                    continue
                hyps.append(self.tokenizer.decode(
                    tokens[i], skip_special_tokens=True))
                lab = labels[i]
                refs.append(self.tokenizer.decode(
                    lab[lab != -100], skip_special_tokens=True))
        return {"predict_wer": wer(refs, hyps),
                "predict_cer": cer(refs, hyps),
                "n_examples": len(refs)}

    def evaluate(self, params, eval_fn, eval_batches, heartbeat=None):
        """Teacher-forced eval: the example-weighted mean of the batches'
        mean losses (the reference Trainer's eval_loss; batches without a
        label token left out) and, with a tokenizer, CER / WER of the
        argmax predictions."""
        losses, weights, all_preds, all_labels = [], [], [], []
        for batch in eval_batches():
            if heartbeat is not None:
                heartbeat()
            out = eval_fn(params, batch)
            if float(out["n_tokens"]) > 0:
                losses.append(float(out["loss"]))
                weights.append(float(out["n_examples"]))
            # every data rank's rows, the same on every rank
            rows = lambda x: mesh_lib.allgather_rows(_host(x), self.mesh)
            labels = rows(batch["labels"])
            real = batch.get("example_mask")
            real = (np.ones(len(labels), bool) if real is None
                    else rows(real))
            all_preds.append(rows(out["predictions"])[real])
            all_labels.append(labels[real])
        total_w = sum(weights)
        metrics = {"eval_loss": (
            float(np.dot(losses, weights) / total_w) if total_w > 0
            else float("nan"))}
        if self.tokenizer is not None:
            preds = [p for arr in all_preds for p in arr]
            labels = [l for arr in all_labels for l in arr]
            metrics.update(compute_metrics(preds, labels, self.tokenizer))
        return metrics
