"""The device mesh on torch.distributed (port of
``speechmix_tpu.parallel.mesh``).

In the JAX package one process drives every device of a host and GSPMD
inserts the collectives.  In the port one process drives one card (a rank),
and every collective is written out (``parallel.collectives``).  A rank sits
at coordinates (data, model, seq) of the mesh shape (n_data, n_model,
n_seq), laid out data-major as ``np.asarray(devices).reshape(n_data,
n_model, n_seq)`` lays out the JAX mesh:

  data  — batch rows: each data rank runs its rows; gradients are summed
          over the data group, and the losses divide by the global counts;
  model — tensor parallelism: the attention heads and the FFN columns of a
          block are split over the model group (q/k/v and fc1 / fc_gate
          column-parallel, out_proj and fc2 row-parallel, an all-reduce
          after them);
  seq   — sequence parallelism: the speech encoder's transformer layers run
          on this rank's time slice, their self-attention as ring attention
          (``ops.ring_attention``) over the seq group.

``Mesh`` holds the shape, this rank's coordinates, one process group per
axis (None without torch.distributed) and the device.  ``make_mesh()``
without a process group is the 1x1x1 mesh; that path runs no collective.

The sharding plan (``param_sharding``) is the JAX package's, leaf for leaf
(``_param_spec_for`` on the JAX layout of the port's tree, then the same
divisibility fallback), with one rule of the port's own: where the model
axis does not divide a block's head count, its attention leaves stay
replicated (explicit tensor parallelism splits at head boundaries; GSPMD
shards the columns anyway).  ``heads_replicated`` lists those leaves.

The ops read the active mesh from ``tp_sharding`` / ``seq_sharding``
contexts, as the JAX package's trace does.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS)
_ATTENTION_LEAVES = ("q_proj", "k_proj", "v_proj", "out_proj", "qkv_proj")


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading dimension
    of a tensor, the counterpart of jax.sharding.PartitionSpec."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"

    def dim_of(self, axis: str) -> Optional[int]:
        """The dimension sharded over `axis`, or None."""
        return self.index(axis) if axis in self else None


class Mesh:
    """One rank's view of the mesh: ``shape`` {axis: size}, ``coords``
    {axis: index}, ``rank`` / ``world``, the device, and per axis the
    process group of this rank's line along it with its global ranks
    (``group(axis)``, ``ranks(axis)``)."""

    def __init__(self, n_data, n_model, n_seq, rank=0, world=1, groups=None,
                 device=None):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model, SEQ_AXIS: n_seq}
        self.rank, self.world = rank, world
        d, rest = divmod(rank, n_model * n_seq)
        m, s = divmod(rest, n_seq)
        self.coords = {DATA_AXIS: d, MODEL_AXIS: m, SEQ_AXIS: s}
        self._groups = groups or {}
        self.device = device

    n_data = property(lambda self: self.shape[DATA_AXIS])
    n_model = property(lambda self: self.shape[MODEL_AXIS])
    n_seq = property(lambda self: self.shape[SEQ_AXIS])
    data_rank = property(lambda self: self.coords[DATA_AXIS])
    model_rank = property(lambda self: self.coords[MODEL_AXIS])
    seq_rank = property(lambda self: self.coords[SEQ_AXIS])

    def group(self, axis):
        """The process group along `axis` (None: no torch.distributed)."""
        return self._groups.get(axis, (None, [self.rank]))[0]

    def ranks(self, axis):
        """The global ranks of this rank's group along `axis`, by index."""
        return self._groups.get(axis, (None, [self.rank]))[1]

    @property
    def distributed(self) -> bool:
        return bool(self._groups)

    def __repr__(self):
        return (f"Mesh({self.n_data}x{self.n_model}x{self.n_seq}, rank "
                f"{self.rank} at {self.coords})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              n_seq: int = 1, device=None) -> Optional[Mesh]:
    """This rank's mesh over the torch.distributed world (one rank without
    a process group).  n_data defaults to the world size over n_model *
    n_seq; the JAX package's assertions hold.  As the JAX mesh takes the
    first devices, the mesh takes ranks 0 .. n_data*n_model*n_seq - 1; a
    rank beyond them gets None.  Every rank of the world must call it (the
    axis groups are made by all, in one order: new_group's rule).  device:
    this rank's card (default: the current CUDA device; 'cpu' to stay on
    the CPU)."""
    from ..ops.kernels._cuda import resolve_device
    import torch.distributed as dist
    dist_on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if dist_on else 1
    rank = dist.get_rank() if dist_on else 0
    n_total = world
    if n_data is None:
        n_data = n_total // (n_model * n_seq)
    # the JAX package's assertions, raised so that -O keeps them
    if n_data < 1:
        raise AssertionError(
            f"mesh needs n_model*n_seq={n_model * n_seq} <= {n_total} "
            f"devices (model_parallel x sequence_parallel exceeds the "
            f"device count)")
    used = n_data * n_model * n_seq
    if used > n_total:
        raise AssertionError(f"mesh {n_data}x{n_model}x{n_seq} needs {used} "
                             f"devices, have {n_total}")
    groups = {}
    if dist_on:
        grid = np.arange(used).reshape(n_data, n_model, n_seq)
        for axis_i, axis in enumerate(AXES):
            lines = np.moveaxis(grid, axis_i, -1).reshape(-1,
                                                          grid.shape[axis_i])
            for line in lines:
                ranks = [int(r) for r in line]
                pg = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = (pg, ranks)
    if rank >= used:
        return None
    return Mesh(n_data, n_model, n_seq, rank, world, groups,
                resolve_device(device))


# ----------------------------------------------------------------------------
# the sharding plan
# ----------------------------------------------------------------------------

def _param_spec_for(path: str, shape) -> P:
    """The JAX package's tensor-parallel rules over the `model` axis, for a
    leaf of the JAX layout at `path` with `shape`: q/k/v kernels shard their
    output dim, out_proj its input dim, ffn_in / fc1 / fc_gate their output
    dim, ffn_out / fc2 their input dim; everything else is replicated.
    Stacked layer leaves carry a leading layer axis: the spec shifts right.
    (Substring rules: int8 ``kernel_q`` / ``kernel_scale`` match too.)"""
    ndim = len(shape)
    stacked = (("/layers/" in path or path.endswith("layers")) and ndim >= 2)
    lead = (None,) if stacked else ()

    def spec(*rest):
        return P(*(lead + rest))

    if ndim == 0 or ndim == 1:
        return P()
    if "q_proj/kernel" in path or "k_proj/kernel" in path or \
            "v_proj/kernel" in path:
        return spec(None, MODEL_AXIS)
    if "out_proj/kernel" in path:
        return spec(MODEL_AXIS, None)
    if ("ffn_in/kernel" in path or "fc1/kernel" in path or
            "fc_gate/kernel" in path):
        return spec(None, MODEL_AXIS)
    if "ffn_out/kernel" in path or "fc2/kernel" in path:
        return spec(MODEL_AXIS, None)
    return P()


def _divisible(spec: P, shape, n: int) -> bool:
    """The JAX package's check: every dim sharded over `model` divides by
    n.  A spec longer than the leaf (a stacked int8 kernel_scale) has no
    such dim to shard and stays replicated."""
    if len(spec) > len(shape):
        return False
    return all(shape[i] % n == 0 for i, ax in enumerate(spec)
               if ax == MODEL_AXIS)


def _heads_of(path: str, cfg) -> Optional[int]:
    """The head count of the attention block a leaf at `path` belongs to,
    None for a leaf outside attention (or without a config)."""
    if cfg is None or not any(f"{n}/" in path for n in _ATTENTION_LEAVES):
        return None
    if hasattr(cfg, "encoder") and hasattr(cfg, "decoder"):
        sub = cfg.encoder if path.startswith("speech_encoder") else cfg.decoder
    else:
        sub = cfg
    return sub.num_heads


def _plan_groups(mesh, params, cfg=None):
    """[(jax path, LayoutGroup, JAX spec, port spec in the JAX layout)] of
    the port's `params`: the JAX plan, then the head-boundary rule."""
    from .. import convert
    n = mesh.n_model
    out = []
    for path, group in convert.flatten_with_paths(
            convert.jax_layout_groups(params)):
        shape = group.shape
        spec = _param_spec_for(path, shape) if n > 1 else P()
        if not _divisible(spec, shape, n):
            spec = P()
        port = spec
        heads = _heads_of(path, cfg)
        if MODEL_AXIS in spec and heads is not None and heads % n:
            port = P()
        out.append((path, group, spec, port))
    return out


def _port_layout(spec: P, group) -> P:
    """A spec of the JAX layout as a spec of each port tensor of `group`
    (the layer axis dropped, a conv kernel's axes reversed)."""
    if not spec:
        return P()
    axes = tuple(spec)
    if group.stacked:
        axes = axes[1:]
    if group.conv:
        axes = (axes + (None,) * (3 - len(axes)))[::-1]
    return P(*axes)


def _map_groups(params, fn, groups):
    """A port-shaped tree with fn(path, group, spec, port) at each tensor."""
    from ..training.freezing import tree_map
    by_id = {}
    for entry in groups:
        for t in entry[1].tensors:
            by_id[id(t)] = entry
    return tree_map(lambda t: fn(*by_id[id(t)]), params)


def param_sharding(mesh: Mesh, params, cfg=None):
    """The plan of `params` (a port-shaped tree): a tree of the same shape
    with a P per tensor, in the port tensor's layout.  Replicated over data
    and seq; over model the JAX package's rules (and with `cfg`, a
    SpeechMixConfig or Seq2SeqConfig, attention kept whole where the heads
    do not divide)."""
    return _map_groups(params, lambda path, g, spec, port: _port_layout(
        port, g), _plan_groups(mesh, params, cfg))


def jax_param_specs(mesh: Mesh, params, cfg=None, port_rule=True):
    """{JAX path: P in the JAX layout}: the plan as the JAX package's
    param_sharding gives it (port_rule=False) or as the port applies it."""
    return {path: (port if port_rule else spec)
            for path, _, spec, port in _plan_groups(mesh, params, cfg)}


def heads_replicated(mesh: Mesh, params, cfg) -> list:
    """The JAX paths that the JAX package shards over model and the port
    keeps whole, because the block's heads do not divide by n_model."""
    return [path for path, _, spec, port in _plan_groups(mesh, params, cfg)
            if spec != port]


def shard_tensor(t, spec: P, mesh: Mesh):
    """This model rank's share of `t` under `spec` (a copy), or `t`."""
    dim = spec.dim_of(MODEL_AXIS)
    if dim is None or mesh.n_model == 1:
        return t
    size = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * size, size).clone()


def shard_params(mesh: Mesh, params, cfg=None):
    """This rank's local tree: every tensor's model share under the plan
    (data and seq ranks hold the whole tree)."""
    from ..training.freezing import tree_map
    return tree_map(lambda t, s: shard_tensor(t, s, mesh), params,
                    param_sharding(mesh, params, cfg))


def opt_state_sharding(mesh: Mesh, opt_state):
    """The JAX package's ZeRO-1 specs of the optimizer state, {JAX path of
    the optax state: P}, computed from the port's state in the JAX layout
    with the JAX package's algorithm: a param-shaped moment inherits the
    param's model spec, then the first free dim divisible by n_data is
    sharded over data.  The port holds ZeRO-1 state by whole JAX-layout
    leaves instead (``zero1_owners``: a leaf's owner keeps and updates it),
    so that Adafactor's row and column statistics stay whole; the model
    entries are the ones the port applies to AdamW's moments."""
    from .. import convert
    name = convert._optimizer_name(opt_state)
    groups = (convert._stat_groups if name == "adafactor"
              else convert.jax_layout_groups)
    tree = {"1": {"0": {".count": None,
                        **{f".{k}": convert._jax_sorted(groups(opt_state[k]))
                           for k in convert._OPT_FIELDS[name]}},
                  "2": {".count": None}}}
    n_data, n_model = mesh.n_data, mesh.n_model
    out = {}
    for path, group in convert.flatten_with_paths(tree):
        shape = () if group is None else tuple(group.shape)
        ndim = len(shape)
        spec = [None] * ndim
        if n_model > 1 and ndim >= 2:
            mspec = _param_spec_for(path, shape)
            if len(mspec) <= ndim and all(
                    shape[i] % n_model == 0
                    for i, ax in enumerate(mspec) if ax == MODEL_AXIS):
                for i, ax in enumerate(mspec):
                    spec[i] = ax
        for i in range(ndim):
            if spec[i] is None and shape[i] >= n_data \
                    and shape[i] % n_data == 0:
                spec[i] = DATA_AXIS
                break
        out[path] = P(*spec)
    return out


def zero1_owners(sizes, n_data: int) -> list:
    """The data rank that owns each leaf of ZeRO-1 state, given the leaves'
    sizes in bytes: the largest leaf first, each to the least loaded rank
    (ties to the lower rank).  Every rank's share is at most the total over
    n_data plus the largest leaf."""
    load = [0] * n_data
    owners = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n_data), key=lambda r: (load[r], r))
        owners[i] = r
        load[r] += sizes[i]
    return owners


def shard_opt_state(mesh: Mesh, opt_state, owners):
    """This data rank's ZeRO-1 share of a port optimizer state: `owners`
    gives the owning data rank of each leaf of its statistics trees (AdamW:
    one per parameter tensor; Adafactor: one per JAX-layout leaf), in
    their flattening order; every leaf another data rank owns becomes
    None.  (``training.sharded.StepLayout`` makes the owners.)"""
    from .. import convert
    from ..training.freezing import tree_map, tree_paths
    out = dict(opt_state)
    for k in convert._OPT_FIELDS[convert._optimizer_name(opt_state)]:
        mine = {id(t) for (_, t), owner in zip(tree_paths(opt_state[k]),
                                               owners)
                if owner == mesh.data_rank}
        out[k] = tree_map(lambda t: t if id(t) in mine else None,
                          opt_state[k])
    return out


def batch_sharding(mesh: Mesh) -> P:
    """The spec of a (B, ...) batch: rows over data."""
    return P(DATA_AXIS)


def local_batch_index(rows: int, n_data: int, data_rank: int,
                      accum: int = 1) -> np.ndarray:
    """The rows of a global batch of `rows` (grad_accum micro-batches of
    rows / accum) that data rank `data_rank` of `n_data` holds: its share of
    each micro-batch, in micro-batch order, so that its step's micro-batch i
    is its share of the global micro-batch i."""
    if rows % (accum * n_data):
        raise ValueError(f"batch of {rows} rows does not divide into "
                         f"{accum} micro-batches over {n_data} data ranks")
    micro, per = rows // accum, rows // accum // n_data
    return np.concatenate([np.arange(i * micro + data_rank * per,
                                     i * micro + (data_rank + 1) * per)
                           for i in range(accum)])


def local_batch(mesh: Mesh, batch, accum: int = 1):
    """This data rank's rows (``local_batch_index``) of a global batch (a
    dict of arrays or tensors), as tensors on the mesh's device."""
    from ..data.prefetch import _as_tensor
    rows = len(next(iter(batch.values())))
    idx = torch_index(local_batch_index(rows, mesh.n_data, mesh.data_rank,
                                        accum))
    return {k: _as_tensor(v)[idx].to(mesh.device) for k, v in batch.items()}


def torch_index(idx):
    import torch
    return torch.from_numpy(np.asarray(idx, dtype=np.int64))


def shard_batch(mesh: Mesh, batch, accum: int = 1):
    """Place a host batch for this rank, as the JAX package's shard_batch:
    with one process, its data rank's rows of the global batch
    (``local_batch``); with several, each process already holds its rows
    (the multihost data path), moved to the device as they are."""
    if process_count() > 1:
        from ..data.prefetch import _as_tensor
        return {k: _as_tensor(v).to(mesh.device) for k, v in batch.items()}
    return local_batch(mesh, batch, accum)


# ----------------------------------------------------------------------------
# the contexts the ops read
# ----------------------------------------------------------------------------

_SEQ_SHARDING = None
_TP_SHARDING = None


@contextlib.contextmanager
def seq_sharding(mesh: Optional[Mesh]):
    """Mark the enclosed forward as sequence-parallel over `mesh` (see
    active_seq_mesh); None disables it."""
    global _SEQ_SHARDING
    prev = _SEQ_SHARDING
    _SEQ_SHARDING = mesh
    try:
        yield
    finally:
        _SEQ_SHARDING = prev


@contextlib.contextmanager
def tp_sharding(mesh: Optional[Mesh]):
    """Mark the enclosed forward as running on `mesh` (its tensor-parallel
    and data-parallel reads: active_tp_mesh, active_mesh); None disables
    it."""
    global _TP_SHARDING
    prev = _TP_SHARDING
    _TP_SHARDING = mesh
    try:
        yield
    finally:
        _TP_SHARDING = prev


def active_seq_mesh() -> Optional[Mesh]:
    """The active seq_sharding mesh when its seq axis is parallel."""
    m = _SEQ_SHARDING
    return m if m is not None and m.n_seq > 1 else None


def active_tp_mesh() -> Optional[Mesh]:
    """The active tp_sharding mesh when its model axis is parallel."""
    m = _TP_SHARDING
    return m if m is not None and m.n_model > 1 else None


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing forward, whatever its shape."""
    return _TP_SHARDING if _TP_SHARDING is not None else _SEQ_SHARDING


def tp_split(count: int) -> int:
    """Into how many model shares a block of `count` heads (or FFN columns)
    is split under the active mesh: n_model where it divides, else 1."""
    m = active_tp_mesh()
    return m.n_model if m is not None and count % m.n_model == 0 else 1


def local_slice(t, width: int, dim: int = -1):
    """This model rank's `width` entries of a replicated vector or table
    along `dim` (a column-parallel layer's bias or int8 scales, T5's
    per-head position table); `t` itself where it is that wide already."""
    if t is None or t.shape[dim] == width:
        return t
    m = active_tp_mesh()
    if m is None or t.shape[dim] != width * m.n_model:
        raise ValueError(f"cannot take a share of width {width} from a "
                         f"tensor of {t.shape[dim]} along {dim}")
    return t.narrow(dim, m.model_rank * width, width)


def fold_key(key, *axes):
    """`key` with this rank's index folded in along each of `axes` whose
    size under the active mesh is above 1 (the masks of tensors sharded
    there must differ between ranks); unchanged without a mesh."""
    m = active_mesh()
    if key is None or m is None:
        return key
    for axis in axes:
        if m.shape[axis] > 1:
            key = key.fold_in(0x3E5 + AXES.index(axis)).fold_in(
                m.coords[axis])
    return key


def data_sum(x):
    """`x` (a tensor; no gradient) summed over the active mesh's data group
    (the global count behind a mean over the global batch); `x` without
    one."""
    m = active_mesh()
    if m is None or m.group(DATA_AXIS) is None:
        return x
    from . import collectives
    return collectives.all_reduce(x.detach().clone(), m.group(DATA_AXIS))


def data_global_rows(rows: int) -> int:
    """The rows of the global batch, given this data rank's."""
    m = active_mesh()
    return rows * m.n_data if m is not None else rows


# ----------------------------------------------------------------------------
# processes and hosts
# ----------------------------------------------------------------------------

def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           timeout_s: float = 600.0):
    """init_process_group once per process.  With no arguments, from the
    torchrun environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK);
    else coordinator_address ("host:port", or an init_method URL such as
    file:///path) with num_processes and process_id.  backend: "nccl" on
    the card, "gloo" on the CPU (the default picks by CUDA).  Each rank
    takes cuda:LOCAL_RANK when there is a card."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init = "env://"
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
        process_id = int(os.environ.get("RANK", 0))
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def per_host_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) \
        -> slice:
    """The rows of a global batch that this process feeds.  In the port
    the slice is keyed on the data rank (the model and seq ranks of one
    data shard need the same rows); without a mesh, on the process index
    over the process count, as the JAX package keys it."""
    if mesh is not None:
        n, i = mesh.n_data, mesh.data_rank
    else:
        n, i = process_count(), process_index()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_examples_per_host(examples, process_index=None,
                            process_count=None):
    """Round-robin dataset sharding: process i keeps examples[i::n]
    (identity on one process).  The training pipeline does not use it: every
    process batches the whole list and slices each global batch."""
    import torch.distributed as dist
    on = dist.is_initialized()
    n = process_count if process_count is not None else (
        dist.get_world_size() if on else 1)
    i = process_index if process_index is not None else (
        dist.get_rank() if on else 0)
    if n <= 1:
        return list(examples)
    return list(examples)[i::n]


def local_rows(x):
    """This rank's rows of a data-sharded result as a numpy array (the
    port's results are local already: the inverse of shard_batch's row
    split is allgather_rows)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def allgather_rows(x, mesh: Optional[Mesh] = None):
    """Every data rank's rows (numpy, equal shapes on every rank) in data
    order, the same on every rank; identity without a data group."""
    x = np.asarray(x)
    if mesh is None:
        mesh = active_mesh()
    if mesh is None or mesh.group(DATA_AXIS) is None:
        return x
    import torch
    from . import collectives
    t = torch.from_numpy(np.ascontiguousarray(x))
    return collectives.all_gather(t, mesh.group(DATA_AXIS),
                                  dim=0).numpy()
