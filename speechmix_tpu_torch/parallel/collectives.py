"""Every collective of the port, and the autograd functions that tensor and
sequence parallelism need.

A group whose backend is NCCL takes the CUDA tensors themselves.  A gloo
group works on host memory: a CUDA tensor is copied to pinned host memory,
reduced or exchanged there, and copied back (``STAGED_BYTES`` counts the
bytes copied out to the host).  The group's backend chooses the route.  A
group of None (no torch.distributed) makes every collective the identity.

The autograd functions (Megatron-LM's pairs):
  * ``copy_to_model``: identity forward, all-reduce over the model group
    backward (the replicated input of a column-parallel layer);
  * ``reduce_from_model``: all-reduce forward, identity backward (the
    partial sums of a row-parallel layer);
  * ``split_time`` / ``gather_time``: this seq rank's slice of the time axis
    forward, the all-gather backward, and the reverse (the speech encoder's
    layers under sequence parallelism).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# bytes copied from the card to host memory for gloo collectives
STAGED_BYTES = {"count": 0}


def reset_staged_bytes():
    STAGED_BYTES["count"] = 0


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_host(t):
    if t.device.type != "cuda":
        return t
    STAGED_BYTES["count"] += t.numel() * t.element_size()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _back(host, like):
    if like.device.type != "cuda":
        return host
    return host.to(like.device, non_blocking=False)


def _wire(t, group):
    """(tensor to hand to the backend, restore fn)."""
    if t.dtype == torch.bool:   # the backends reduce no bool: as uint8
        u, back = _wire(t.to(torch.uint8), group)
        return u, lambda x: back(x).bool()
    if group is not None and _staged(group):
        h = _to_host(t.contiguous())
        return h, lambda x: _back(x, t)
    if group is not None and t.device.type != "cuda":
        # NCCL moves device memory only
        return t.to(torch.device("cuda", torch.cuda.current_device())), \
            lambda x: x.to(t.device)
    return t.contiguous(), lambda x: x


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """The reduction of `t` over `group` (a new tensor; `t` may be
    overwritten)."""
    if group is None:
        return t
    w, back = _wire(t, group)
    dist.all_reduce(w, op=op, group=group)
    return back(w)


def all_gather(t, group, dim=0):
    """The group's tensors of `t`'s shape, concatenated along `dim` in the
    group's rank order."""
    if group is None:
        return t
    w, back = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return back(torch.cat(parts, dim=dim))


def reduce_scatter(t, group, dim=0):
    """This rank's share along `dim` of the sum of the group's `t`."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    total = all_reduce(t.clone(), group)
    size = t.shape[dim] // n
    return total.narrow(dim, dist.get_group_rank(group, dist.get_rank())
                        * size, size).contiguous()


def broadcast(t, src: int, group):
    """`t` of global rank `src` on every rank of `group` (written into `t`
    and returned)."""
    if group is None:
        return t
    w, back = _wire(t, group)
    dist.broadcast(w, src=src, group=group)
    out = back(w)
    if out is not t:
        t.copy_(out)
    return t


class RingExchange:
    """Send tensors to the next rank of a ring and receive the previous
    rank's, started at once and finished by ``wait()`` (the transfer runs
    while the caller computes)."""

    def __init__(self, tensors, group, ranks, me):
        n = len(ranks)
        nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
        # the send buffers live until wait()
        self.sent, self.recv, self.backs = [], [], []
        ops = []
        for t in tensors:
            w, back = _wire(t, group)
            r = torch.empty_like(w)
            self.sent.append(w)
            self.recv.append(r)
            self.backs.append(back)
            ops += [dist.P2POp(dist.isend, w, nxt, group),
                    dist.P2POp(dist.irecv, r, prv, group)]
        self.reqs = dist.batch_isend_irecv(ops)

    def wait(self):
        for r in self.reqs:
            r.wait()
        return [back(r) for r, back in zip(self.recv, self.backs)]


# ----------------------------------------------------------------------------
# autograd functions
# ----------------------------------------------------------------------------

class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTime(torch.autograd.Function):
    """(B, T, ...) -> this rank's (B, T / n, ...) slice."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group = group
        size = x.shape[1] // n
        return x.narrow(1, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, dim=1), None, None, None


class _GatherTime(torch.autograd.Function):
    """this rank's (B, T / n, ...) slice -> (B, T, ...)."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.index, ctx.size = index, x.shape[1]
        return all_gather(x.contiguous(), group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(1, ctx.index * ctx.size, ctx.size).contiguous(),
                None, None, None)


def copy_to_model(x, mesh):
    """Identity forward; the gradient all-reduced over the model group."""
    if mesh is None or mesh.group("model") is None:
        return x
    return _CopyToRegion.apply(x, mesh.group("model"))


def reduce_from_model(x, mesh):
    """x summed over the model group; the gradient passes unchanged."""
    if mesh is None or mesh.group("model") is None:
        return x
    return _ReduceFromRegion.apply(x, mesh.group("model"))


def split_time(x, mesh):
    """This seq rank's slice of axis 1 (its length divides by n_seq)."""
    return _SplitTime.apply(x, mesh.group("seq"), mesh.seq_rank, mesh.n_seq)


def gather_time(x, mesh):
    """The seq group's slices of axis 1, joined in rank order."""
    return _GatherTime.apply(x, mesh.group("seq"), mesh.seq_rank, mesh.n_seq)
