"""Ring attention: non-causal self-attention over the seq group (port of
``speechmix_tpu.ops.ring_attention``).

Under sequence parallelism each seq rank holds a (B, T / n, H, D) slice of
q, k and v (T padded to a multiple of n, the padded keys masked).  The K/V
blocks and their key mask go round the ring with ``batch_isend_irecv``
(rank i sends to i + 1), n - 1 hops; each hop starts the next block's
transfer before it computes on the block it holds, and merges the block's
result into the running online softmax (row max m, denominator l,
unnormalised accumulator), the flash recurrence lifted from key tiles to
ranks.  The per-hop block is plain PyTorch, as the JAX package's is XLA
einsums; a block where a row has no valid key gives l = 0 for that row and
contributes nothing.  Heads are this rank's: under tensor parallelism the
q / k / v projections already split them over the model group.

The JAX package differentiates its ring by transposing ``ppermute``; here
the backward is written out (``_Ring``): it runs the ring again, recomputes
each block's probabilities from the forward's final m and l, and sends the
dk / dv accumulators round with the blocks, so that after the last hop one
more transfer hands each rank the gradient of its own keys and values.

Probability dropout masks each hop's contribution to the accumulator but
never l (dropout on the normalised probabilities); the mask of (rank, hop)
is drawn from the key folded with both, rows (b * H + h) * Tq + q of the
block, so the backward draws it again.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from .kernels import dropout as drop

NEG_INF = -1e30


def _block_scores(q, k, valid, scale):
    """f32 scores (B, H, Tq, Tk) of q against one block, masked keys at
    NEG_INF."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.where(valid[:, None, None, :] > 0, s, NEG_INF)


def _keep(key, hop, seq_rank, shape, rate, device):
    """The block's dropout multiplier (0 or 1 / (1 - rate)), or None."""
    if key is None or rate <= 0.0:
        return None
    k = key.fold_in(seq_rank).fold_in(hop)
    b, h, tq, tk = shape
    mask = drop.dropout_mask(k, drop.STREAM_ACT, b * h * tq, tk, rate,
                             device)
    return mask.view(shape)


def _block_attn(q, k, v, valid, scale, keep=None):
    """One block: (acc (B, Tq, H, D) f32 = sum_k exp(s - m) [* keep] v,
    m (B, H, Tq) the block's row max (NEG_INF where no key is valid),
    l (B, H, Tq) the block's sum exp(s - m), 0 there)."""
    s = _block_scores(q, k, valid, scale)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid[:, None, None, :]
    l = p.sum(-1)
    p_acc = p if keep is None else p * keep
    acc = torch.einsum("bhqk,bkhd->bqhd", p_acc, v.float())
    return acc, m, l


def _combine(m_run, l_run, acc_run, m_new, l_new, acc_new):
    """Online-softmax merge of two partial results."""
    m_out = torch.maximum(m_run, m_new)
    alpha = torch.exp(m_run - m_out)
    beta = torch.exp(m_new - m_out)
    l_out = alpha * l_run + beta * l_new
    acc_out = (alpha.transpose(1, 2)[..., None] * acc_run
               + beta.transpose(1, 2)[..., None] * acc_new)
    return m_out, l_out, acc_out


def _ring_forward(q, k, v, valid, scale, mesh, key, rate):
    b, tq, h, _ = q.shape
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    n = mesh.n_seq
    block = (k, v, valid)
    for hop in range(n):
        ex = None
        if hop < n - 1:
            ex = collectives.RingExchange(block, mesh.group("seq"),
                                          mesh.ranks("seq"), mesh.seq_rank)
        keep = _keep(key, hop, mesh.seq_rank, (b, h, tq, block[0].shape[1]),
                     rate, q.device)
        a2, m2, l2 = _block_attn(q, block[0], block[1], block[2], scale, keep)
        m, l, acc = _combine(m, l, acc, m2, l2, a2)
        if ex is not None:
            block = tuple(ex.wait())
    return acc, m, l


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, scale, mesh, key, rate):
        acc, m, l = _ring_forward(q, k, v, valid, scale, mesh, key, rate)
        denom = torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
        out = acc / denom
        ctx.save_for_backward(q, k, v, valid, out, m, l)
        ctx.args = (scale, mesh, key, rate)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, out, m, l = ctx.saved_tensors
        scale, mesh, key, rate = ctx.args
        g = g.float()
        b, tq, h, _ = q.shape
        qf = q.float()
        # D = rowsum(dO * O) per (b, h, q)
        delta = (g * out).sum(-1).transpose(1, 2)
        inv_l = torch.where(l > 0, 1.0 / torch.clamp_min(l, 1e-30), 0.0)
        dq = torch.zeros_like(qf)
        n = mesh.n_seq
        kb, vb, validb = k, v, valid
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for hop in range(n):
            s = _block_scores(q, kb, validb, scale)
            p = (torch.exp(s - m[..., None]) * inv_l[..., None]
                 * validb[:, None, None, :])
            keep = _keep(key, hop, mesh.seq_rank, p.shape, rate, q.device)
            p_out = p if keep is None else p * keep
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p_out, g)
            dp = torch.einsum("bqhd,bkhd->bhqk", g, vb.float())
            if keep is not None:
                dp = dp * keep
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            if n > 1:
                # the accumulators travel with their block; after the last
                # hop one more transfer brings them home
                tensors = (dk, dv) if hop == n - 1 else (kb, vb, validb,
                                                         dk, dv)
                got = collectives.RingExchange(
                    tensors, mesh.group("seq"), mesh.ranks("seq"),
                    mesh.seq_rank).wait()
                if hop == n - 1:
                    dk, dv = got
                else:
                    kb, vb, validb, dk, dv = got
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention_eligible(mesh, num_heads: int, causal: bool,
                            has_bias: bool, has_cache: bool) -> bool:
    """The JAX package's ring dispatch predicate: a mesh whose seq axis is
    parallel, non-causal, no extra bias, no cache, heads divisible by the
    model axis."""
    if mesh is None or causal or has_bias or has_cache:
        return False
    if mesh.n_seq <= 1:
        return False
    return num_heads % mesh.n_model == 0


def ring_attention(q, k, v, kv_mask, *, scale, mesh, dropout_rate=0.0,
                   dropout_key=None):
    """Non-causal attention of this seq rank's queries over the keys of the
    whole seq group.  q / k / v: (B, T_local, H, D), this rank's slice of a
    time axis padded to a multiple of n_seq (and its heads); kv_mask:
    (B, T_local) key mask (bool or {0, 1}) or None.  Returns (B, T_local,
    H, D) in q's dtype, differentiable in q, k and v."""
    b, t = k.shape[:2]
    if kv_mask is None:
        valid = torch.ones((b, t), dtype=torch.float32, device=k.device)
    else:
        valid = kv_mask.to(torch.float32).contiguous()
    rate = float(dropout_rate) if dropout_key is not None else 0.0
    return _Ring.apply(q, k, v, valid, float(scale), mesh, dropout_key,
                       rate)


def pad_time(x, n):
    """x (B, T, ...) zero-padded along T to a multiple of n."""
    pad = -x.shape[1] % n
    if not pad:
        return x
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype,
                                     device=x.device)], dim=1)
