"""The T5 / ByT5 text model of the port against the JAX package, float32 on
the CPU: relative-position buckets (exact), the position bias, the RMS norm,
encode / decode / seq2seq_apply (logits and hidden states), cached single
steps against the uncached pass, the routes of a cached step (the
self-attention on the plain biased path, the cross-attention through K4's
wrapper at scale 1), the loss gradient against jax.grad, and the pre-LN
blocks with dropout given JAX's own masks.

Two configurations: tiny-t5-bytes (relu FFN, tied head, 2 + 2 layers) and a
ByT5-like one (gated GELU, untied head, 3 + 2 layers, H = 48 against 2 x 16
attention channels, as byt5-small's 1472 against 6 x 64); the forward also
runs tiny-bart-bytes with the gated GELU, which BART's post-LN blocks take
outside the fused kernels.  Weights are the JAX initialisation with the
matrices redrawn at std 0.1, the position tables at 1.0 and the RMS scales
near 1 (numpy, seeded); both sides get the same numpy inputs.  The JAX functions are jitted once per configuration with
the weights as arguments.

Tolerances: values within 1e-5 of the largest reference magnitude (f32 sums
in another order); bucket ids and routes exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.ops import layers as j_layers
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.ops import attention as t_attn
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from speechmix_tpu_torch.training.freezing import tree_map
from test_torch_train import _flat
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
BYT5_LIKE = dict(name="tiny-byt5", hidden_size=48, encoder_layers=3,
                 decoder_layers=2, num_heads=2, head_dim=16, ffn_dim=96,
                 vocab_size=384, max_length=32)


def _s2s_cfg(m, name):
    if name == "t5":
        return m.SEQ2SEQ_PRESETS["tiny-t5-bytes"]
    if name == "bart_gated":
        return dataclasses.replace(m.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
                                   activation="gelu_gated")
    return dataclasses.replace(m.SEQ2SEQ_PRESETS["byt5-small"], **BYT5_LIKE)


def smx_cfgs(name, variant="eed"):
    """The (JAX, port) SpeechMix configs of tiny-speech (2 layers) and the
    text model `name` ("t5", "byt5" or "bart_gated")."""
    def build(m):
        enc = dataclasses.replace(m.SPEECH_ENCODER_PRESETS["tiny-speech"],
                                  num_layers=2)
        return m.SpeechMixConfig(encoder=enc, decoder=_s2s_cfg(m, name),
                                 down_scale=2, variant=variant)
    return build(jcfg), build(tcfg)


def smx_tree(jc, seed=1):
    """The JAX initialisation as numpy, matrices redrawn at std 0.1, the
    T5 position tables at 1.0, RMS scales at 1 + 0.1 N(0, 1)."""
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "rel_bias" in name:
            return rng.randn(*a.shape).astype(np.float32)
        if "nlp" in name and "layer_norm" in name:
            return (1.0 + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX seq2seq cfg, port cfg, JAX nlp params, port nlp params)."""
    jc, tc = smx_cfgs(name)
    tree = smx_tree(jc)
    return (jc.decoder, tc.decoder,
            jax.tree_util.tree_map(jnp.asarray, tree["nlp"]),
            convert.params_from_jax(tree, tc)["nlp"])


def _inputs(cfg, seed=0, b=2, t=11, l=7):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, cfg.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, 8:] = False
    labels = rng.randint(2, cfg.vocab_size, (b, l)).astype(np.int32)
    labels[1, 5:] = -100
    return ids, mask, labels


def _close(got, ref, rel=REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _j_apply(name):
    jd = case(name)[0]
    return jax.jit(lambda p, ids, mask, labels: j_s2s.seq2seq_apply(
        p, jd, input_ids=ids, attention_mask=mask, labels=labels,
        output_hidden_states=True))


@functools.lru_cache(maxsize=None)
def _j_step(name):
    jd = case(name)[0]
    return jax.jit(lambda p, ids, mask, cache: j_s2s.decode(
        p, jd, ids, encoder_mask=mask, cache=cache))


def _port_apply(name, ids, mask, labels, params=None, **kw):
    _, td, _, tp = case(name)
    return t_s2s.seq2seq_apply(
        tp if params is None else params, td,
        input_ids=torch.from_numpy(ids).long(),
        attention_mask=torch.from_numpy(mask),
        labels=torch.from_numpy(labels).long(), **kw)


# ---------------------------------------------------------------- buckets

@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 20)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_equal_jax(bidirectional, num_buckets,
                                    max_distance):
    """Every relative position in [-400, 400]: both directions, 0, the
    exact range's end max_exact and the far range past max_distance."""
    rel = np.arange(-400, 401, dtype=np.int32)
    ref = np.asarray(j_s2s._t5_relative_bucket(
        jnp.asarray(rel), bidirectional, num_buckets, max_distance))
    got = t_s2s._t5_relative_bucket(torch.from_numpy(rel).long(),
                                    bidirectional, num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), ref)
    half = num_buckets // 2 if bidirectional else num_buckets
    # past max_distance every position takes the last bucket of its side
    far = got[(rel < -max_distance)]
    assert (far == half - 1).all()


@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_position_bias_and_the_decoders_rows(name):
    """The encoder's bidirectional (1, H, T, T) bias; the decoder's causal
    bias of the uncached pass; and the cached decoder's table: row `offset`
    is the JAX package's per-step bias at that offset (the cache's causal
    mask plus the position bias)."""
    jd, td, jp, tp = case(name)
    for side, bidir, q, kv in (("encoder", True, 13, 13),
                               ("decoder", False, 9, 9)):
        ref = j_s2s.t5_position_bias(jp[side]["rel_bias"], q, kv, bidir, jd)
        got = t_s2s.t5_position_bias(tp[side]["rel_bias"], q, kv, bidir, td)
        assert got.shape == (1, td.num_heads, q, kv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    cap = 12
    enc = torch.zeros(1, 3, td.hidden_size)
    table = t_s2s.init_decoder_cache(tp, td, enc, 1, cap).self_bias
    assert table.shape == (1, td.num_heads, cap, cap)
    step_bias = jax.jit(lambda table, offset: (
        j_s2s.cache_position_bias(cap, offset, 1)
        + j_s2s.t5_position_bias(table, 1, cap, False, jd, q_offset=offset)))
    for offset in range(cap):
        ref = step_bias(jp["decoder"]["rel_bias"], offset)
        np.testing.assert_array_equal(
            table[:, :, offset:offset + 1].numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype,rel", [("float32", 2.0 ** -22),
                                       ("bfloat16", 2.0 ** -8)])
def test_rms_norm(dtype, rel):
    """Statistics in f32, the result cast back to x's dtype: within a few
    f32 ulps (the mean's and rsqrt's own rounding), in bf16 within one
    bf16 ulp."""
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, 48) * 3.0).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(48)).astype(np.float32)
    ref = np.asarray(j_layers.rms_norm({"scale": jnp.asarray(scale)},
                                       jnp.asarray(x).astype(dtype), 1e-6),
                     np.float32)
    got = t_layers.rms_norm({"scale": torch.from_numpy(scale)},
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            1e-6)
    assert got.dtype == getattr(torch, dtype)
    assert (np.abs(got.float().numpy() - ref) <= rel * np.abs(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_head_scales_x_as_jax(dtype, monkeypatch):
    """T5's tied head multiplies the decoder's last states by hidden_size **
    -0.5 in their dtype (the JAX package's weakly typed product: the
    factor rounded to that dtype) before the f32-accumulated product: the
    operand the port hands the head equals JAX's product bit for bit."""
    _, td, _, tp = case("t5")
    seen = []
    orig = t_s2s._tied_logits

    def spy(x, w):
        seen.append(x)
        return orig(x, w)
    monkeypatch.setattr(t_s2s, "_tied_logits", spy)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 3, td.hidden_size) * 4.0).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    logits = t_s2s._lm_logits(tp, td, tx, tx.dtype)
    ref = jnp.asarray(x).astype(dtype) * (td.hidden_size ** -0.5)
    assert seen[0].dtype == tx.dtype and logits.dtype == torch.float32
    np.testing.assert_array_equal(seen[0].float().numpy(),
                                  np.asarray(ref, np.float32))


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("name", ["t5", "byt5", "bart_gated"])
def test_seq2seq_apply_matches_jax(name):
    """Logits, loss and both stacks' hidden states (HF T5Stack convention:
    the last entry after the final norm); bart_gated is BART's post-LN
    blocks around the gated FFN, LN(x + FFN(x)) in plain PyTorch."""
    ids, mask, labels = _inputs(case(name)[1])
    ref = _j_apply(name)(case(name)[2], ids, mask, labels)
    out = _port_apply(name, ids, mask, labels, output_hidden_states=True)
    for key in ("logits", "encoder_last_hidden_state",
                "encoder_hidden_states", "decoder_hidden_states"):
        _close(out[key], ref[key])
    assert abs(out["loss"].item() - float(ref["loss"])) <= REL * float(
        ref["loss"])
    enc = t_s2s.encode(case(name)[3], case(name)[1],
                       input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask))
    torch.testing.assert_close(enc["last_hidden_state"],
                               out["encoder_last_hidden_state"])


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_cached_steps_match_the_uncached_pass(name, kv_int8):
    """Seven single-token steps over the cache give the uncached pass's
    logits at each position (int8 cross K/V: the JAX package's cached steps
    over its own int8 cache)."""
    jd, td, jp, tp = case(name)
    ids, mask, labels = _inputs(td, seed=4)
    dec_ids = np.array(j_s2s.shift_tokens_right(jnp.asarray(labels), 0, 0))
    enc = t_s2s.encode(tp, td, input_ids=torch.from_numpy(ids).long(),
                       attention_mask=torch.from_numpy(mask))
    h, tmask = enc["last_hidden_state"], torch.from_numpy(mask)
    full = t_s2s.decode(tp, td, torch.from_numpy(dec_ids).long(), tmask,
                        enc_hidden=h)["logits"]
    cache = t_s2s.init_decoder_cache(tp, td, h, 2, 10, kv_int8=kv_int8)
    jcache = j_s2s.init_decoder_cache(jp, jd, jnp.asarray(h.numpy()), 2, 10,
                                      kv_int8=kv_int8)
    for t in range(dec_ids.shape[1]):
        step = t_s2s.decode(tp, td, torch.from_numpy(dec_ids[:, t:t + 1])
                            .long(), tmask, cache)
        jstep = _j_step(name)(jp, dec_ids[:, t:t + 1], mask, jcache)
        cache, jcache = step["cache"], jstep["cache"]
        _close(step["logits"], jstep["logits"])
        if not kv_int8:
            _close(step["logits"][:, 0], full[:, t].detach().numpy())
    assert cache.self_kv.index == dec_ids.shape[1]


def test_cached_step_routes(monkeypatch):
    """A T5 cached step: the self-attention on the plain path with the
    (1, H, 1, capacity) bias row and no K4 call; the cross-attention
    through K4's wrapper (decode_attention) at scale 1.0, once per layer."""
    _, td, _, tp = case("t5")
    k4, plain = [], []

    def spy_k4(*args, _orig=t_s2s.decode_attention, **kw):
        k4.append(kw["scale"])
        return _orig(*args, **kw)

    def spy_self_k4(*args, **kw):
        raise AssertionError("a T5 self-attention step reached K4")

    def spy_attend(q, k, v, bias, scale, *args, _orig=t_attn._attend):
        plain.append((tuple(bias.shape), scale, k.shape[1]))
        return _orig(q, k, v, bias, scale, *args)
    monkeypatch.setattr(t_s2s, "decode_attention", spy_k4)
    monkeypatch.setattr(t_attn, "decode_attention", spy_self_k4)
    monkeypatch.setattr(t_attn, "_attend", spy_attend)
    h = torch.randn(2, 5, td.hidden_size)
    cache = t_s2s.init_decoder_cache(tp, td, h, 2, 8)
    for t in range(3):
        cache = t_s2s.decode(tp, td, torch.full((2, 1), 5), None,
                             cache)["cache"]
    n = td.decoder_layers
    assert k4 == [1.0] * (3 * n)
    assert plain == [((1, td.num_heads, 1, 8), 1.0, 8)] * (3 * n)


# ---------------------------------------------------------------- gradient

@functools.lru_cache(maxsize=None)
def _j_grad(name):
    jd = case(name)[0]

    def loss(p, ids, mask, labels):
        return j_s2s.seq2seq_apply(p, jd, input_ids=ids, attention_mask=mask,
                                   labels=labels)["loss"]
    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_loss_gradient_matches_jax_grad(name, monkeypatch):
    """d loss / d params in f32, every dropout rate 0 (no key), leaf by
    leaf within 1e-5 of the leaf's largest reference magnitude; the relu
    FFN with the row and width gates lowered, so it runs the fused
    function K9 / K8 (their plain versions here) with no biases."""
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", 1)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
    calls = []
    orig = t_layers.ffn_kernels.ffn_fused_trainable

    def spy(x, w1, b1, w2, b2, act):
        calls.append((b1, b2))
        return orig(x, w1, b1, w2, b2, act)
    monkeypatch.setattr(t_layers.ffn_kernels, "ffn_fused_trainable", spy)
    jd, td, jp, tp = case(name)
    ids, mask, labels = _inputs(td, seed=6)
    ref_loss, ref = _j_grad(name)(jp, ids, mask, labels)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    out = _port_apply(name, ids, mask, labels, params=params)
    assert abs(out["loss"].item() - float(ref_loss)) <= REL * float(ref_loss)
    out["loss"].backward()
    got = _flat(convert.tree_to_jax_layout(tree_map(lambda p: p.grad,
                                                    params)))
    want = _flat(ref)
    assert got.keys() == want.keys()
    for path, r in want.items():
        assert got[path].shape == r.shape, path
        err = np.abs(got[path] - r).max()
        assert err <= REL * np.abs(r).max() + 1e-9, (path, err)
    relu = td.activation == "relu"
    assert len(calls) == (td.encoder_layers + td.decoder_layers) * relu
    assert all(b == (None, None) for b in calls)


# ---------------------------------------------------------------- dropout

def _jax_masks(keys, shapes, rate):
    """JAX's keep masks of layers.dropout as the port's scaled masks."""
    return [np.where(np.asarray(jax.random.bernoulli(k, 1.0 - rate, s)),
                     np.float32(1.0 / (1.0 - rate)), np.float32(0.0))
            for k, s in zip(keys, shapes)]


@pytest.mark.parametrize("block", ["encoder", "decoder"])
@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_blocks_with_dropout_given_jax_masks(name, block, monkeypatch):
    """A pre-LN block with every dropout site live (rate 0.1): JAX's
    _encoder_block / uncached _decoder_block with its rng, and the port's
    block with the mask generator replaced by JAX's masks, site by site in
    HF's order (attention probabilities, attention output, [cross
    probabilities, cross output,] activation, FFN output)."""
    jd, td, jp, tp = case(name)
    rate = td.dropout
    assert td.attention_dropout == td.activation_dropout == rate
    rng = np.random.RandomState(8)
    b, t, te = 2, 6, 5
    x = rng.randn(b, t, td.hidden_size).astype(np.float32)
    enc = rng.randn(b, te, td.hidden_size).astype(np.float32)
    emask = np.ones((b, te), bool)
    emask[1, 3:] = False
    heads, f = td.num_heads, td.ffn_dim
    key = jax.random.PRNGKey(11)
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp[block]["layers"])
    tblock = tp[block]["layers"][0]
    if block == "encoder":
        bias = j_s2s.t5_position_bias(jp[block]["rel_bias"], t, t, True, jd)
        ref = j_s2s._encoder_block(jblock, jd, jnp.asarray(x), bias,
                                   jnp.ones((b, t), bool), False,
                                   jnp.float32, key)
        k_attn, k_h1, k_act, k_h2 = jax.random.split(key, 4)
        sites = [(k_attn, (b, heads, t, t)), (k_h1, (b, t, td.hidden_size)),
                 (k_act, (b, t, f)), (k_h2, (b, t, td.hidden_size))]
    else:
        bias = j_s2s.t5_position_bias(jp[block]["rel_bias"], t, t, False, jd)
        cross_bias = j_s2s.combine_masks_to_bias(kv_mask=jnp.asarray(emask))
        ref, _ = j_s2s._decoder_block(
            jblock, jd, jnp.asarray(x), bias, cross_bias, jnp.asarray(enc),
            None, None, False, jnp.float32,
            self_kv_mask=jnp.ones((b, t), bool), self_causal=True,
            dropout_rng=key)
        ks = jax.random.split(key, 6)
        sites = [(ks[0], (b, heads, t, t)), (ks[1], (b, t, td.hidden_size)),
                 (ks[2], (b, heads, t, te)), (ks[3], (b, t, td.hidden_size)),
                 (ks[4], (b, t, f)), (ks[5], (b, t, td.hidden_size))]
    masks = _jax_masks([k for k, _ in sites], [s for _, s in sites], rate)
    fed = []

    def jax_mask(key, stream, n, cols, r, device=None):
        m = masks[len(fed)]
        assert r == rate and m.size == n * cols, (len(fed), m.shape, n, cols)
        fed.append(stream)
        return torch.from_numpy(m.reshape(n, cols))
    monkeypatch.setattr(t_layers.drop, "dropout_mask", jax_mask)
    dkey = t_drop.DropoutKey.from_seed(3)
    if block == "encoder":
        tbias = t_s2s.t5_position_bias(tp[block]["rel_bias"], t, t, True, td)
        got = t_s2s._encoder_block(tblock, td, torch.from_numpy(x),
                                   torch.ones(b, t, dtype=torch.bool),
                                   torch.float32, dkey, tbias)
    else:
        tbias = t_s2s.t5_position_bias(tp[block]["rel_bias"], t, t, False,
                                       td)
        got, _ = t_s2s._decoder_block(
            tblock, td, torch.from_numpy(x), tbias,
            torch.ones(b, t, dtype=torch.bool), None, None, None, None,
            torch.float32, self_causal=True, enc_hidden=torch.from_numpy(enc),
            cross_bias=t_s2s.combine_masks_to_bias(
                kv_mask=torch.from_numpy(emask)), dropout_rng=dkey)
    assert len(fed) == len(masks)
    _close(got, ref)
