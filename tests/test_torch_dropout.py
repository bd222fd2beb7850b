"""The port's dropout generator and its dropout kernels' plain versions and
differentiable forms, on the CPU, float32.

Generator: Philox-4x32-10 against Random123's known answers, the keep rate,
distinct streams and keys, and that an element's bit depends on its
coordinates only (any sub-block regenerates it).  The keep rule against the
TPU package's _dropout_scale_from_bits on the same bits.

JAX parity: the JAX package's dropout functions run on the CPU through their
XLA twins, whose mask is _xla_dropout_mask (as tests/test_ffn_dropout.py and
tests/test_flash_dropout.py run them).  Each test draws that mask, hands it
to the port's plain version as an explicit mask, and holds the forward and
jax.grad to 1e-5 of the largest reference magnitude (f32; order of summation
only).

Seed-based functions: each autograd function of the port equals torch
autograd through its explicit-mask plain chain, with the mask regenerated
from the same key, so its backward regenerates the forward's mask.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu.ops.pallas.flash_attention_kernel import (
    _dropout_scale_from_bits, _xla_dropout_mask, flash_attention_dropout)
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
N, H, F = 48, 32, 64
EPS = 1e-5


def _close(got, ref, name="", rel=REL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    limit = rel * np.abs(ref).max() + 1e-7
    err = np.abs(got - ref).max()
    assert err <= limit, f"{name}: {err} > {limit}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------- generator
@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors of philox4x32_10."""
    out = t_drop.philox4x32(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(o) for o in out) == want


def test_mulhilo_is_exact():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 32, size=4096, dtype=np.uint64)
    for m in (0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF, 1):
        hi, lo = t_drop._mulhilo(torch.from_numpy(a.astype(np.int64)), m)
        full = [int(v) * m for v in a]
        assert hi.tolist() == [p >> 32 for p in full]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in full]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_four_sigma(rate):
    n = 1000
    mask = t_drop.dropout_mask(t_drop.DropoutKey.from_seed(3), 0, n, n, rate,
                               "cpu")
    scale = np.float32(1.0 / (1.0 - rate))
    assert set(torch.unique(mask).tolist()) == {0.0, float(scale)}
    keep = (mask > 0).double().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / n ** 2)
    assert abs(keep - (1 - rate)) < 4 * sigma, keep


def test_keep_rule_matches_the_tpu_package():
    """The same bits through the TPU package's threshold and scale."""
    key = t_drop.DropoutKey.from_seed(11)
    bits = t_drop.dropout_bits(key, 1, 64, 96)
    for rate in (0.1, 0.3, 1e-12, 1 - 1e-9):
        ref = _dropout_scale_from_bits(
            jnp.asarray(bits.numpy().astype(np.uint32)), rate)
        threshold, scale = t_drop.threshold_and_scale(rate)
        got = torch.where(bits >= threshold, scale, 0.0).float()
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_streams_and_keys_differ():
    key = t_drop.DropoutKey.from_seed(0)
    masks = [t_drop.dropout_mask_plain(k, s, 64, 64, 0.5)
             for k in (key, key.fold_in(1), *key.split(2)) for s in (0, 1)]
    for i in range(len(masks)):
        for j in range(i):
            assert not torch.equal(masks[i], masks[j]), (i, j)
    again = t_drop.dropout_mask_plain(t_drop.DropoutKey.from_seed(0), 0, 64,
                                      64, 0.5)
    assert torch.equal(masks[0], again)


def test_key_chain_is_host_integers():
    key = t_drop.DropoutKey.from_seed(7)
    assert key.fold_in(3) == t_drop.DropoutKey.from_seed(7).fold_in(3)
    assert key.split(3)[1] == key.split(5)[1]
    assert len({key.fold_in(i) for i in range(100)} |
               set(key.split(100))) == 200
    assert all(0 <= w < 2 ** 32 for w in key.words())
    assert t_drop.split_or_none(None, 3) == (None, None, None)
    with pytest.raises(TypeError):
        t_drop.check_key(torch.Generator())


@pytest.mark.parametrize("r0,r1,c0,c1", [(0, 64, 0, 96), (5, 37, 3, 50),
                                         (63, 64, 95, 96)])
def test_bits_depend_on_coordinates_only(r0, r1, c0, c1):
    """Any sub-block, computed element by element from its global
    coordinates (counter (col // 4, row, 0, stream), word col % 4), equals
    the slice of the whole mask: tiling cannot change a bit."""
    key = t_drop.DropoutKey.from_seed(5)
    whole = t_drop.dropout_bits(key, 1, 64, 96)
    rows = torch.arange(r0, r1)[:, None].expand(-1, c1 - c0)
    cols = torch.arange(c0, c1)[None, :].expand(r1 - r0, -1)
    words = torch.stack(t_drop.philox4x32(
        cols >> 2, rows, torch.zeros_like(rows), torch.ones_like(rows),
        *key.words()), -1)
    block = torch.gather(words, -1, (cols & 3)[..., None])[..., 0]
    assert torch.equal(block, whole[r0:r1, c0:c1])


def test_attention_mask_is_the_flat_mask():
    key = t_drop.DropoutKey.from_seed(2)
    m4 = t_drop.attention_mask_plain(key, 2, 3, 5, 7, 0.2)
    flat = t_drop.dropout_mask_plain(key, t_drop.STREAM_ACT, 30, 7, 0.2)
    assert torch.equal(m4.reshape(30, 7), flat)


def test_layers_dropout():
    x = torch.randn(3, 4, 8)
    key = t_drop.DropoutKey.from_seed(1)
    assert t_layers.dropout(x, 0.1, None) is x
    assert t_layers.dropout(x, 0.0, key) is x
    y = t_layers.dropout(x, 0.25, key, t_drop.STREAM_OUT)
    mask = t_drop.dropout_mask_plain(key, t_drop.STREAM_OUT, 12, 8, 0.25)
    assert torch.equal(y, x * mask.view(3, 4, 8))


# ------------------------------------------------------- FFN: JAX parity
def _ffn_operands(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(N, H).astype(np.float32) * 0.5,
        w1=rng.randn(H, F).astype(np.float32) * 0.2,
        b1=rng.randn(F).astype(np.float32) * 0.1,
        w2=rng.randn(F, H).astype(np.float32) * 0.2,
        b2=rng.randn(H).astype(np.float32) * 0.1,
        res=rng.randn(N, H).astype(np.float32),
        g=1.0 + 0.1 * rng.randn(H).astype(np.float32),
        beta=0.1 * rng.randn(H).astype(np.float32))


def _jax_and_port_grads(j_fn, t_fn, ops, names, cot_seed=9):
    """Forward and the gradients of sum(out * cot) wrt `names`, JAX and
    port (torch autograd through the plain chain)."""
    j_ops = [jnp.asarray(ops[n]) for n in names]
    j_out, vjp = jax.vjp(j_fn, *j_ops)
    cot = np.random.RandomState(cot_seed).randn(*j_out.shape).astype(
        np.float32)
    j_grads = vjp(jnp.asarray(cot))
    t_ops = [_t(ops[n]).requires_grad_() for n in names]
    t_out = t_fn(*t_ops)
    t_grads = torch.autograd.grad(t_out, t_ops, _t(cot))
    return (j_out, j_grads), (t_out, t_grads)


@pytest.mark.parametrize("act_rate,out_rate", [(0.1, 0.0), (0.0, 0.1),
                                               (0.1, 0.1)])
def test_ffn_dropout_res_ln_matches_jax(act_rate, out_rate):
    ops, seed = _ffn_operands(), 17
    amask = (np.asarray(_xla_dropout_mask(seed, (N, F), act_rate))
             if act_rate else None)
    omask = (np.asarray(_xla_dropout_mask(seed + 1, (N, H), out_rate))
             if out_rate else None)
    names = ("x", "w1", "b1", "w2", "b2", "res", "g", "beta")
    (j_out, j_grads), (t_out, t_grads) = _jax_and_port_grads(
        lambda *a: fk.ffn_dropout_res_ln_trainable(
            *a, seed, "gelu", act_rate, out_rate, EPS, N, F),
        lambda *a: t_ffn.ffn_dropout_res_ln_plain(
            *a, None if amask is None else _t(amask),
            None if omask is None else _t(omask), "gelu", EPS),
        ops, names)
    _close(t_out, j_out, "out")
    for name, got, ref in zip(names, t_grads, j_grads):
        _close(got, ref, f"d {name}")


def test_ffn_dropout_matches_jax():
    ops, seed, rate = _ffn_operands(1), 23, 0.1
    amask = _t(_xla_dropout_mask(seed, (N, F), rate))
    names = ("x", "w1", "b1", "w2", "b2")
    (j_out, j_grads), (t_out, t_grads) = _jax_and_port_grads(
        lambda *a: fk.ffn_dropout_trainable(*a, seed, "gelu", rate, N, F),
        lambda *a: t_ffn.ffn_dropout_plain(*a, amask, "gelu"), ops, names)
    _close(t_out, j_out, "out")
    for name, got, ref in zip(names, t_grads, j_grads):
        _close(got, ref, f"d {name}")
    # K8's dropout backward formula (the kernels' arithmetic) against
    # jax.grad of the same function
    cot = _t(np.random.RandomState(9).randn(N, H))
    t = {n: _t(ops[n]) for n in names}
    dx, dw1, db1, dw2, db2 = t_ffn.ffn_bwd_plain(
        t["x"], cot, t["w1"], t["b1"], t["w2"], "gelu", amask)
    for name, got, ref in zip(names, (dx, dw1, db1, dw2, db2), j_grads):
        _close(got, ref, f"ffn_bwd_plain with amask d {name}")


def test_dense_dropout_res_ln_matches_jax():
    ops, seed, rate = _ffn_operands(2), 31, 0.1
    ops["w"] = ops["w1"][:, :H] * 1.0
    omask = _t(_xla_dropout_mask(seed, (N, H), rate))
    names = ("x", "w", "b2", "res", "g", "beta")
    (j_out, j_grads), (t_out, t_grads) = _jax_and_port_grads(
        lambda *a: fk.dense_dropout_res_ln_trainable(*a, seed, rate, EPS, N),
        lambda *a: t_ffn.dense_dropout_res_ln_plain(*a, omask, EPS), ops,
        names)
    _close(t_out, j_out, "out")
    for name, got, ref in zip(names, t_grads, j_grads):
        _close(got, ref, f"d {name}")


# ------------------------------------------------- attention: JAX parity
B, T, HEADS, D = 2, 24, 2, 16


def _attention_operands(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, T, HEADS, D).astype(np.float32) * 0.5
                  for _ in range(4))
    mask = np.ones((B, T), bool)
    mask[1, 17:] = False
    return q, k, v, g, mask


@pytest.mark.parametrize("masked,causal", [(True, False), (False, True),
                                           (True, True)])
def test_attention_dropout_matches_jax(masked, causal):
    q, k, v, g, mask = _attention_operands()
    kv_mask = mask if masked else None
    seed, rate, scale = 5, 0.2, 1.0 / math.sqrt(D)
    dmask = _t(_xla_dropout_mask(seed, (B, HEADS, T, T), rate))
    j_out, vjp = jax.vjp(
        lambda q_, k_, v_: flash_attention_dropout(
            q_, k_, v_, None if kv_mask is None else jnp.asarray(kv_mask),
            seed, scale, causal, rate),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(g))
    slab = lambda a: _t(a.reshape(B, T, HEADS * D))
    t_mask = None if kv_mask is None else torch.from_numpy(kv_mask)
    out = t_attn.attention_fwd_plain(slab(q), slab(k), slab(v), t_mask,
                                     HEADS, scale, causal, dmask=dmask)
    _close(out.reshape(B, T, HEADS, D), j_out, "out")
    grads = t_attn.attention_bwd_plain(slab(q), slab(k), slab(v), t_mask,
                                       slab(g), HEADS, scale, causal,
                                       dmask=dmask)
    for name, got, ref in zip("qkv", grads, j_grads):
        _close(got.reshape(B, T, HEADS, D), ref, f"d{name}")


# ------------------------- seed-based functions against their mask chains
def _autograd_pair(fn, chain, tensors, cot_seed=4):
    a = [t.clone().requires_grad_() for t in tensors]
    b = [t.clone().requires_grad_() for t in tensors]
    out_a, out_b = fn(*a), chain(*b)
    cot = torch.from_numpy(np.random.RandomState(cot_seed).randn(
        *out_a.shape).astype(np.float32))
    return (out_a, torch.autograd.grad(out_a, a, cot),
            out_b, torch.autograd.grad(out_b, b, cot))


@pytest.mark.parametrize("act_rate,out_rate", [(0.1, 0.1), (0.0, 0.2),
                                               (0.3, 0.0)])
def test_ffn_dropout_res_ln_trainable_regenerates_its_masks(act_rate,
                                                            out_rate):
    ops = _ffn_operands(3)
    key = t_drop.DropoutKey.from_seed(8).fold_in(2)
    amask = (t_drop.dropout_mask_plain(key, t_drop.STREAM_ACT, N, F, act_rate)
             if act_rate else None)
    omask = (t_drop.dropout_mask_plain(key, t_drop.STREAM_OUT, N, H, out_rate)
             if out_rate else None)
    names = ("x", "w1", "b1", "w2", "b2", "res", "g", "beta")
    out_a, ga, out_b, gb = _autograd_pair(
        lambda *a: t_ffn.ffn_dropout_res_ln_trainable(
            *a, key, act_rate, out_rate, "gelu", EPS),
        lambda *a: t_ffn.ffn_dropout_res_ln_plain(*a, amask, omask, "gelu",
                                                  EPS),
        [_t(ops[n]) for n in names])
    _close(out_a, out_b.detach().numpy(), "out")
    for name, x, y in zip(names, ga, gb):
        _close(x, y.numpy(), f"d {name}")


def test_dense_and_ffn_dropout_trainable_regenerate_their_masks():
    ops = _ffn_operands(4)
    key = t_drop.DropoutKey.from_seed(9)
    w = _t(ops["w1"][:, :H])
    omask = t_drop.dropout_mask_plain(key, t_drop.STREAM_OUT, N, H, 0.1)
    out_a, ga, out_b, gb = _autograd_pair(
        lambda *a: t_ffn.dense_dropout_res_ln_trainable(*a, key, 0.1, EPS),
        lambda *a: t_ffn.dense_dropout_res_ln_plain(*a, omask, EPS),
        [_t(ops["x"]), w, _t(ops["b2"]), _t(ops["res"]), _t(ops["g"]),
         _t(ops["beta"])])
    _close(out_a, out_b.detach().numpy(), "dense out")
    for i, (x, y) in enumerate(zip(ga, gb)):
        _close(x, y.numpy(), f"dense grad {i}")
    amask = t_drop.dropout_mask_plain(key, t_drop.STREAM_ACT, N, F, 0.15)
    names = ("x", "w1", "b1", "w2", "b2")
    out_a, ga, out_b, gb = _autograd_pair(
        lambda *a: t_ffn.ffn_dropout_trainable(*a, key, 0.15, "gelu_new"),
        lambda *a: t_ffn.ffn_dropout_plain(*a, amask, "gelu_new"),
        [_t(ops[n]) for n in names])
    _close(out_a, out_b.detach().numpy(), "ffn out")
    for name, x, y in zip(names, ga, gb):
        _close(x, y.numpy(), f"ffn d {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_trainable_regenerates_its_mask(causal):
    q, k, v, _, mask = _attention_operands(1)
    slab = lambda a: _t(a.reshape(B, T, HEADS * D))
    kv_mask, scale = torch.from_numpy(mask), 0.25
    key = t_drop.DropoutKey.from_seed(4).split(3)[2]
    dmask = t_drop.attention_mask_plain(key, B, HEADS, T, T, 0.1)
    out_a, ga, out_b, gb = _autograd_pair(
        lambda q_, k_, v_: t_attn.attention_dropout_trainable(
            q_, k_, v_, kv_mask, HEADS, scale, causal, key, 0.1),
        lambda q_, k_, v_: t_attn.attention_fwd_plain(
            q_, k_, v_, kv_mask, HEADS, scale, causal, dmask=dmask),
        [slab(q), slab(k), slab(v)])
    _close(out_a, out_b.detach().numpy(), "out")
    for name, x, y in zip("qkv", ga, gb):
        _close(x, y.numpy(), f"d{name}")


def test_dropout_wrappers_raise_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises (a meta
    tensor fails the CUDA check; K10 asked for the card fails without
    CUDA or builds its kernel)."""
    meta = lambda *s: torch.empty(*s, device="meta")
    key = t_drop.DropoutKey.from_seed(0)
    x, w1, w2 = meta(4, 8), meta(8, 16), meta(16, 8)
    v8, v16 = meta(8), meta(16)
    calls = [
        lambda: t_ffn.dense_dropout_res_ln(x, meta(8, 8), v8, x, v8, v8, key,
                                           0.1),
        lambda: t_ffn.ffn_dropout_res_ln(x, w1, v16, w2, v8, x, v8, v8, key,
                                         0.1, 0.1),
        lambda: t_ffn.ffn_dropout(x, w1, v16, w2, v8, key, 0.1),
        lambda: t_ffn.ffn_dropout_bwd_dx(x, x, w1, v16, w2, key, 0.1),
        lambda: t_ffn.ffn_dropout_bwd_dw(x, x, w1, v16, w2, key, 0.1),
        lambda: t_attn.attention_dropout_fwd(
            meta(1, 8, 64), meta(1, 8, 64), meta(1, 8, 64), None, 1, 0.125,
            False, key, 0.1),
        lambda: t_attn.attention_dropout_bwd(
            meta(1, 8, 64), meta(1, 8, 64), meta(1, 8, 64), None,
            meta(1, 8, 64), meta(1, 1, 8), meta(1, 8, 64), 1, 0.125, False,
            key, 0.1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
