"""The train step's collectives under a mesh: which gradients are summed
over which group, the global gradient norm, ZeRO-1 ownership and the
broadcast of updated parameters, and the gathered / scattered full train
state that npz checkpoints read and write.

Gradient sums (every rank holds the local tree of ``mesh.shard_params``):
  * data: every leaf (each data rank's loss is its share of the global
    batch's, ``layers.cross_entropy_with_ignore``);
  * model: a replicated leaf of which a rank uses only its share, so that
    its gradient is partial: the bias (or int8 scales) of a column-parallel
    projection, and T5's position table when the heads are split.  A
    replicated leaf used on replicated activations (norms, row-parallel
    biases, embeddings) has the same gradient on every model rank and is not
    summed;
  * seq: the speech encoder's layers under sequence parallelism, which run
    on time slices.  What runs before the split or after the gather sees
    the whole sequence and is not summed.

ZeRO-1: each leaf of optimizer state has one owner among the data ranks
(``mesh.zero1_owners``, by the leaf's bytes): only the owner keeps and
updates that leaf, then broadcasts the updated parameters to its data
group.  Adafactor's leaves are the JAX layout's (a stacked layer list is
one leaf), so its row and column statistics and its block RMS are taken
over the whole leaf; under tensor parallelism its gradient is gathered over
the model group first and the update sliced back to the rank's share.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from .freezing import tree_map, tree_paths

_COLUMN_BIAS_OWNERS = ("q_proj", "k_proj", "v_proj", "fc1", "fc_gate",
                       "ffn_in")


class StepLayout:
    """The mesh plan of one train step: per port leaf its model spec and
    the groups its gradient is summed over, and (ZeRO-1) the data rank that
    owns each leaf of optimizer state."""

    def __init__(self, mesh, cfg, params, optimizer: str, zero1: bool,
                 seq_parallel: bool):
        self.mesh = mesh
        self.seq_parallel = seq_parallel and mesh.n_seq > 1
        specs = mesh_lib.param_sharding(mesh, params, cfg)
        paths = tree_paths(params)
        spec_of = dict(zip((p for p, _ in paths),
                           (s for _, s in _spec_paths(specs))))
        self.spec = {id(t): spec_of[p] for p, t in paths}
        self.sums = {}
        for path, t in paths:
            groups = [DATA_AXIS]
            if mesh.n_model > 1 and _partial_over_model(path, spec_of, cfg,
                                                        mesh):
                groups.append(MODEL_AXIS)
            if self.seq_parallel and path.startswith("speech_encoder/layers/"):
                groups.append(SEQ_AXIS)
            self.sums[id(t)] = tuple(groups)
        # JAX-layout groups: the model dim of each in the JAX layout
        self.jax_dim = {}
        for _, g in convert.flatten_with_paths(
                convert.jax_layout_groups(params)):
            dim = self.spec[id(g.tensors[0])].dim_of(MODEL_AXIS)
            if dim is not None and g.stacked:
                dim += 1
            self.jax_dim[id(g.tensors[0])] = dim
        self.owner = None
        if zero1 and mesh.n_data > 1:
            self.owner = _owners(params, optimizer, mesh, self)

    def model_dim(self, t):
        return self.spec[id(t)].dim_of(MODEL_AXIS)

    def mine(self, t) -> bool:
        """Whether this data rank keeps the optimizer state of `t`."""
        return self.owner is None or \
            self.owner[id(t)] == self.mesh.data_rank

    def global_shape(self, group) -> list:
        """The shape in the JAX layout of a JAX-layout group's whole leaf."""
        shape = list(group.shape)
        dim = self.jax_dim[id(group.tensors[0])]
        if dim is not None:
            shape[dim] *= self.mesh.n_model
        return shape

    def group_dim(self, group):
        return self.jax_dim[id(group.tensors[0])]


def _spec_paths(specs):
    """[(path, P)] of a port-shaped tree of specs (P is a tuple: do not
    descend into it)."""
    out = []

    def walk(t, prefix):
        if isinstance(t, mesh_lib.P):
            out.append((prefix, t))
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            for i, v in enumerate(t):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
    walk(specs, "")
    return out


def _partial_over_model(path, spec_of, cfg, mesh) -> bool:
    parent, name = path.rsplit("/", 1)
    if name in ("bias", "kernel_scale"):
        kernel = spec_of.get(f"{parent}/kernel",
                             spec_of.get(f"{parent}/kernel_q"))
        return (parent.rsplit("/", 1)[-1] in _COLUMN_BIAS_OWNERS
                and kernel is not None and kernel.dim_of(MODEL_AXIS) == 1)
    if path.endswith("rel_bias/embedding"):
        heads = cfg.decoder.num_heads if hasattr(cfg, "decoder") else \
            cfg.num_heads
        return heads % mesh.n_model == 0
    return False


def _owners(params, optimizer, mesh, layout):
    """{id(tensor): owning data rank}: AdamW by port tensor (its moments,
    8 bytes an element), Adafactor by JAX-layout leaf (its statistics)."""
    if optimizer == "adamw":
        leaves = [t for _, t in tree_paths(params)]
        ranks = mesh_lib.zero1_owners([8 * t.numel() for t in leaves],
                                      mesh.n_data)
        return {id(t): r for t, r in zip(leaves, ranks)}
    groups = [g for _, g in convert.flatten_with_paths(
        convert.jax_layout_groups(params))]
    sizes = [4 * _adafactor_elements(layout.global_shape(g)) for g in groups]
    ranks = mesh_lib.zero1_owners(sizes, mesh.n_data)
    return {id(t): r for g, r in zip(groups, ranks) for t in g.tensors}


def _adafactor_elements(shape) -> int:
    if len(shape) < 2:
        return int(np.prod(shape))
    order = np.argsort(shape)
    d1, d0 = int(order[-2]), int(order[-1])
    n = int(np.prod(shape))
    return n // shape[d0] + n // shape[d1]


def reduce_gradients(grads, layout: StepLayout):
    """Sum each gradient over its groups, in place, one collective per
    group over the flattened leaves."""
    mesh = layout.mesh
    leaves = [g for _, g in tree_paths(grads)]
    params_ids = list(layout.sums)
    for axis in (DATA_AXIS, MODEL_AXIS, SEQ_AXIS):
        group = mesh.group(axis)
        if group is None:
            continue
        chosen = [g for g, pid in zip(leaves, params_ids)
                  if axis in layout.sums[pid]]
        if not chosen:
            continue
        flat = torch.cat([g.reshape(-1) for g in chosen])
        flat = collectives.all_reduce(flat, group)
        offset = 0
        for g in chosen:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def global_norm(grads, layout: StepLayout):
    """The gradients' global norm over the whole (unsharded) tree: the
    squares of model-sharded leaves are summed over the model group."""
    from .trainer import global_norm as plain_norm
    mesh = layout.mesh
    if mesh.n_model == 1:
        return plain_norm(grads)
    sharded, replicated = [], []
    for pid, (_, g) in zip(layout.sums, tree_paths(grads)):
        (sharded if layout.spec[pid].dim_of(MODEL_AXIS) is not None
         else replicated).append(g)
    sq = lambda ts: (torch.stack(torch._foreach_norm(ts)).square().sum()
                     if ts else torch.zeros((), device=mesh.device))
    total = collectives.all_reduce(sq(sharded), mesh.group(MODEL_AXIS)) \
        + sq(replicated)
    return torch.sqrt(total)


@torch.no_grad()
def broadcast_updates(params, layout: StepLayout):
    """ZeRO-1: each owner's updated parameters to its data group, one
    broadcast per owner over its leaves flattened."""
    if layout.owner is None:
        return
    mesh = layout.mesh
    leaves = [t for _, t in tree_paths(params)]
    for r in range(mesh.n_data):
        owned = [t for t in leaves if layout.owner[id(t)] == r]
        if not owned:
            continue
        flat = torch.cat([t.reshape(-1) for t in owned])
        collectives.broadcast(flat, mesh.ranks(DATA_AXIS)[r],
                              mesh.group(DATA_AXIS))
        offset = 0
        for t in owned:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def opt_state_bytes(opt_state) -> int:
    """Bytes of the tensors this rank holds in an optimizer state."""
    return sum(t.numel() * t.element_size() for k, v in opt_state.items()
               if k != "count" for _, t in tree_paths(v) if t is not None)


# ----------------------------------------------------------------------------
# the whole state, for npz checkpoints
# ----------------------------------------------------------------------------

def _gather_model(t, dim, mesh):
    if dim is None or mesh.n_model == 1:
        return t
    return collectives.all_gather(t.contiguous(), mesh.group(MODEL_AXIS),
                                  dim=dim)


@torch.no_grad()
def full_state(state, layout: StepLayout, optimizer):
    """The whole TrainState (every shard and every owner's leaves) on every
    rank, as float32 CPU tensors shaped like a one-card state.  Every rank
    of the mesh must call it."""
    from .trainer import TrainState
    mesh = layout.mesh
    dev = mesh.device
    host = lambda t: t.detach().to("cpu", torch.float32, copy=True)
    params = tree_map(lambda t: host(_gather_model(t, layout.model_dim(t),
                                                   mesh)), state.params)
    template = optimizer.__class__(optimizer.tc).init(
        tree_map(lambda t: t.to(dev), params))
    name = convert._optimizer_name(state.opt_state)
    opt = {"count": state.opt_state["count"]}
    for k in convert._OPT_FIELDS[name]:
        live = [t for _, t in tree_paths(state.opt_state[k])]
        want = [t for _, t in tree_paths(template[k])]
        owners = _state_owners(state.params, layout, name)
        dims = _state_dims(state.params, layout, name)
        got = []
        for t_live, t_full, owner, dim in zip(live, want, owners, dims):
            if owner is None or owner == mesh.data_rank:
                full = _gather_model(t_live, dim, mesh)
            else:
                full = torch.empty_like(t_full)
            if owner is not None and mesh.n_data > 1:
                full = collectives.broadcast(
                    full.contiguous(), mesh.ranks(DATA_AXIS)[owner],
                    mesh.group(DATA_AXIS))
            got.append(host(full))
        it = iter(got)
        opt[k] = tree_map(lambda _: next(it), template[k])
    return TrainState(params, opt, state.step)


def _state_owners(params, layout, name):
    """The owner (None: every data rank) of each optimizer-state leaf of
    field trees, in their order."""
    if name == "adamw":
        return [None if layout.owner is None else layout.owner[id(t)]
                for _, t in tree_paths(params)]
    return [None if layout.owner is None else layout.owner[id(g.tensors[0])]
            for _, g in convert.flatten_with_paths(
                convert.jax_layout_groups(params))]


def _state_dims(params, layout, name):
    """The model dim of each optimizer-state leaf (AdamW's moments are
    sharded as their parameters; Adafactor's statistics are whole)."""
    if name == "adamw":
        return [layout.model_dim(t) for _, t in tree_paths(params)]
    return [None for _ in convert.flatten_with_paths(
        convert.jax_layout_groups(params))]


@torch.no_grad()
def load_full_state(state, full, layout: StepLayout):
    """Copy the whole state `full` (a one-card TrainState) into this rank's
    share `state` in place; returns the TrainState with full's counts."""
    from .trainer import TrainState
    mesh = layout.mesh

    def share(t_full, dim):
        if dim is None or mesh.n_model == 1:
            return t_full
        size = t_full.shape[dim] // mesh.n_model
        return t_full.narrow(dim, mesh.model_rank * size, size)
    for (_, t), (_, f) in zip(tree_paths(state.params),
                              tree_paths(full.params)):
        t.copy_(share(f, layout.model_dim(t)))
    name = convert._optimizer_name(state.opt_state)
    dims = _state_dims(state.params, layout, name)
    for k in convert._OPT_FIELDS[name]:
        for (_, t), (_, f), dim in zip(tree_paths(state.opt_state[k]),
                                       tree_paths(full.opt_state[k]), dims):
            if t is not None:
                t.copy_(share(f, dim))
    return TrainState(state.params, {**state.opt_state,
                                     "count": full.opt_state["count"]},
                      full.step)
