"""The port's decode-attention (K4) and fused extractor conv (K6) plain
versions against the JAX package's Pallas kernels in interpret mode, the int8
cross-K/V quantiser and cache, the fused extractor path of extract_features,
and greedy generate with int8 cross K/V, token-exact.

Same numpy inputs (seeded) on both sides, on the CPU, where each wrapper runs
its plain version.  Tolerances: decode attention 1e-5 in float32 and 2e-2 in
bfloat16 (the two sides round the probabilities at the same place but sum in
another order); fused conv 1e-4; quantiser codes exact, scales 1e-7 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.models import speech_encoder as j_se
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.ops.pallas import conv_extractor as j_conv
from speechmix_tpu.ops.pallas import decode_attention as j_da
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.ops.kernels import conv_extractor as t_conv
from speechmix_tpu_torch.ops.kernels import decode_attention as t_da
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quant(x):
    amax = np.abs(x).max(axis=-1)
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    codes = np.clip(np.round(x / scale[..., None]), -127, 127)
    return codes.astype(np.int8), scale


def _attn_inputs(b, t, heads, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, heads, d).astype(np.float32)
    k = rng.randn(b, t, heads, d).astype(np.float32)
    v = rng.randn(b, t, heads, d).astype(np.float32)
    valid = np.array([t, max(1, t // 2), max(1, t // 3), 1])[:b]
    return q, k, v, np.arange(t)[None, :] < valid[:, None]


# ---------------------------------------------------------------------------
# K4 decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,heads,d", [(64, 12, 64), (400, 12, 64),
                                       (37, 4, 32)])
def test_decode_attention_plain_matches_pallas(t, heads, d):
    q, k, v, mask = _attn_inputs(4, t, heads, d, 0)
    scale = 1.0 / np.sqrt(d)
    ref = j_da.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                scale=scale, num_heads=heads,
                                force_pallas=True)
    out = t_da.decode_attention(_t(q), _t(k), _t(v), _t(mask), scale=scale,
                                num_heads=heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_decode_attention_plain_int8_matches_pallas():
    heads, d = 12, 64
    q, kf, vf, mask = _attn_inputs(4, 96, heads, d, 2)
    (k, ks), (v, vs) = _quant(kf), _quant(vf)
    scale = 1.0 / np.sqrt(d)
    ref = j_da.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        scale=scale, num_heads=heads, force_pallas=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = t_da.decode_attention(_t(q), _t(k), _t(v), _t(mask), scale=scale,
                                num_heads=heads, k_scale=_t(ks),
                                v_scale=_t(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_decode_attention_plain_bf16_matches_pallas():
    heads, d = 12, 64
    q, k, v, _ = _attn_inputs(2, 100, heads, d, 1)
    mask = np.ones((2, 100), bool)
    scale = 1.0 / np.sqrt(d)
    ref = j_da.decode_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(mask), scale=scale, num_heads=heads, force_pallas=True)
    out = t_da.decode_attention(*(_t(a).bfloat16() for a in (q, k, v)),
                                _t(mask), scale=scale, num_heads=heads)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_decode_attention_shared_kv_equals_tiled(int8_kv):
    """kb queries per K/V row give what the same queries give against K/V
    tiled kb times: the beams of one input share its cross K/V."""
    heads, d, kb = 4, 64, 3
    _, kf, vf, mask = _attn_inputs(2, 50, heads, d, 3)
    q = np.random.RandomState(4).randn(2 * kb, 1, heads, d).astype(np.float32)
    k, v, scales = kf, vf, {}
    if int8_kv:
        (k, ks), (v, vs) = _quant(kf), _quant(vf)
        scales = dict(k_scale=_t(ks), v_scale=_t(vs))
    rep = lambda a: _t(a).repeat_interleave(kb, dim=0)
    shared = t_da.decode_attention(_t(q), _t(k), _t(v), _t(mask), scale=0.125,
                                   num_heads=heads, **scales)
    tiled = t_da.decode_attention(
        _t(q), rep(k), rep(v), rep(mask), scale=0.125, num_heads=heads,
        **{n: s.repeat_interleave(kb, dim=0) for n, s in scales.items()})
    assert shared.shape == (2 * kb, 1, heads, d)
    np.testing.assert_allclose(shared.numpy(), tiled.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("int8_kv", [False, True])
def test_decode_attention_plain_chunk_equals_single_queries(int8_kv):
    """The plain version takes a multi-token chunk in one pass: q_len
    single-query problems on the same K/V.  The wrapper (the kernel's
    contract) takes single queries only."""
    heads, d, q_len = 4, 64, 3
    _, kf, vf, mask = _attn_inputs(3, 40, heads, d, 8)
    q = _t(np.random.RandomState(9).randn(3, q_len, heads, d)
           .astype(np.float32))
    k, v, scales = kf, vf, {}
    if int8_kv:
        (k, ks), (v, vs) = _quant(kf), _quant(vf)
        scales = dict(k_scale=_t(ks), v_scale=_t(vs))
    args = (_t(k), _t(v), _t(mask))
    kw = dict(scale=0.125, num_heads=heads, **scales)
    chunk = t_da.decode_attention_plain(q, *args, **kw)
    single = torch.cat([t_da.decode_attention(q[:, i:i + 1].contiguous(),
                                              *args, **kw)
                        for i in range(q_len)], dim=1)
    assert chunk.shape == (3, q_len, heads, d)
    np.testing.assert_allclose(chunk.numpy(), single.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="decode_attention needs q"):
        t_da.decode_attention(q, *args, **kw)


def test_decode_attention_fully_masked_row_is_finite():
    q, k, v, _ = _attn_inputs(1, 8, 2, 64, 5)
    out = t_da.decode_attention(_t(q), _t(k), _t(v),
                                torch.zeros(1, 8, dtype=torch.bool),
                                scale=0.125, num_heads=2)
    assert torch.isfinite(out).all()


def test_decode_attention_rejects_bad_query_batch():
    q, k, v, mask = _attn_inputs(2, 8, 2, 64, 6)
    with pytest.raises(ValueError, match="decode_attention needs q"):
        t_da.decode_attention(_t(np.concatenate([q, q[:1]])), _t(k), _t(v),
                              _t(mask), scale=0.125, num_heads=2)


# ---------------------------------------------------------------------------
# int8 cross K/V
# ---------------------------------------------------------------------------

def test_quantize_kv_matches_jax():
    x = np.random.RandomState(7).randn(2, 9, 4, 16).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero head: scale floor
    ref_codes, ref_scale = j_s2s._quantize_kv(jnp.asarray(x))
    codes, scale = t_s2s._quantize_kv(_t(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale),
                               rtol=1e-7, atol=0)


def _tiny_cfgs(**enc_kw):
    mk = lambda m: m.SpeechMixConfig(
        encoder=dataclasses.replace(m.SPEECH_ENCODER_PRESETS["tiny-speech"],
                                    **enc_kw),
        decoder=m.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    return mk(jcfg), mk(tcfg)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = _tiny_cfgs()
    params = j_smx.init_speechmix(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, convert.params_from_jax(tree, tc)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decoder_cache_and_step_match_jax(tiny, kv_int8):
    """init_decoder_cache (codes within one step, scales 1e-6: the
    projections under them differ in the last bit) and three cached steps
    with a JAX cache carried across by convert.cross_kv_from_jax."""
    jc, tc, jp, tp = tiny
    rng = np.random.RandomState(8)
    enc = rng.randn(2, 11, jc.decoder.hidden_size).astype(np.float32)
    enc_mask = np.arange(11)[None, :] < np.array([[11], [7]])
    j_cache = j_s2s.init_decoder_cache(jp["nlp"], jc.decoder,
                                       jnp.asarray(enc), 2, 6,
                                       kv_int8=kv_int8)
    t_cache = t_s2s.init_decoder_cache(tp["nlp"], tc.decoder, _t(enc), 2, 6,
                                       kv_int8=kv_int8)
    for name in ("cross_k", "cross_v"):
        ref = convert.cross_kv_from_jax(getattr(j_cache, name))
        got = getattr(t_cache, name)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if kv_int8:
            # the projections differ in their last bit (order of summation),
            # so a code may land on the neighbouring step
            assert np.abs(got.numpy().astype(np.int32)
                          - ref.numpy().astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    if kv_int8:
        for name in ("cross_k_scale", "cross_v_scale"):
            np.testing.assert_allclose(
                getattr(t_cache, name).numpy(),
                np.asarray(getattr(j_cache, name)), rtol=1e-6, atol=0)
        # the steps below run on the JAX codes, so both sides dequantise
        # the same numbers
        t_cache = t_cache._replace(
            cross_k=convert.cross_kv_from_jax(j_cache.cross_k),
            cross_v=convert.cross_kv_from_jax(j_cache.cross_v))
    else:
        assert t_cache.cross_k_scale is None
    ids = rng.randint(3, 300, size=(2, 5))
    # three single-token steps (K4's plain version), then a two-token chunk
    for lo, hi in ((0, 1), (1, 2), (2, 3), (3, 5)):
        tok = ids[:, lo:hi]
        j_out = j_s2s.decode(jp["nlp"], jc.decoder, jnp.asarray(tok),
                             encoder_mask=jnp.asarray(enc_mask),
                             cache=j_cache)
        t_out = t_s2s.decode(tp["nlp"], tc.decoder, _t(tok), _t(enc_mask),
                             t_cache)
        j_cache, t_cache = j_out["cache"], t_out["cache"]
        np.testing.assert_allclose(t_out["logits"].numpy(),
                                   np.asarray(j_out["logits"]), atol=1e-4)


def test_cross_attention_rejects_mismatched_batches(tiny):
    _, tc, _, tp = tiny
    block = tp["nlp"]["decoder"]["layers"][0]["encoder_attn"]
    h, d = tc.decoder.num_heads, tc.decoder.per_head_dim
    k = torch.zeros(2, 5, h, d)
    x = torch.zeros(3, 1, tc.decoder.hidden_size)
    with pytest.raises(ValueError, match="incompatible with query batch"):
        t_s2s._cross_attention(block, tc.decoder, x, k, k, None,
                               torch.float32)
    x = torch.zeros(4, 1, tc.decoder.hidden_size)
    with pytest.raises(ValueError, match="UNTILED encoder mask"):
        t_s2s._cross_attention(block, tc.decoder, x, k, k,
                               torch.ones(4, 5, dtype=torch.bool),
                               torch.float32)


# ---------------------------------------------------------------------------
# K6 fused extractor conv
# ---------------------------------------------------------------------------

def _conv_layers(rng, c, kernels, ln):
    out = []
    for k in kernels:
        layer = {"conv": {
            "kernel": (rng.randn(k, c, c) / np.sqrt(k * c)).astype(np.float32),
            "bias": (rng.randn(c) * 0.1).astype(np.float32)}}
        if ln:
            layer["norm"] = {
                "scale": (1.0 + 0.1 * rng.randn(c)).astype(np.float32),
                "bias": (0.1 * rng.randn(c)).astype(np.float32)}
        out.append(layer)
    return out


def _torch_layers(layers):
    """(k, C_in, C_out) JAX conv kernels in the port's (C_out, C_in, k)."""
    return [{name: ({"kernel": _t(p["kernel"].transpose(2, 1, 0)),
                     "bias": _t(p["bias"])} if name == "conv"
                    else {n: _t(a) for n, a in p.items()})
             for name, p in layer.items()} for layer in layers]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("ln", [False, True])
def test_fused_conv_layer_plain_matches_pallas(k, ln):
    rng = np.random.RandomState(10 + k)
    c, t_in = 128, 150
    x = rng.randn(2, t_in, c).astype(np.float32)
    layers = _conv_layers(rng, c, (k,), ln)
    ref = j_conv.fused_conv_stack(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, layers), (k,),
        (2,), bt=32, ln_layers=ln, interpret=True)
    tl = _torch_layers(layers)[0]
    out = t_conv.fused_conv_layer(_t(x), tl["conv"]["kernel"],
                                  tl["conv"]["bias"], tl.get("norm"), 1e-5)
    assert out.shape == (2, (t_in - k) // 2 + 1, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ln", [False, True])
def test_fused_conv_stack_plain_matches_pallas(ln):
    rng = np.random.RandomState(20)
    c, kernels = 128, (3, 3, 2, 2)
    x = rng.randn(2, 700, c).astype(np.float32)
    layers = _conv_layers(rng, c, kernels, ln)
    ref = j_conv.fused_conv_stack(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, layers), kernels,
        (2,) * 4, bt=32, ln_layers=ln, interpret=True)
    out = t_conv.fused_conv_stack(_t(x), _torch_layers(layers), ln, 1e-5)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_fused_conv_layer_rejects_other_geometry():
    x = torch.zeros(1, 20, 8)
    with pytest.raises(ValueError, match="k in"):
        t_conv.fused_conv_layer(x, torch.zeros(8, 8, 5))
    with pytest.raises(ValueError, match="C_in == C_out"):
        t_conv.fused_conv_layer(x, torch.zeros(16, 8, 3))


@pytest.mark.parametrize("norm", ["group", "layer"])
def test_extract_features_fused_matches_conv_and_jax(norm):
    jc, tc = _tiny_cfgs(feat_extract_norm=norm, conv_bias=norm == "layer")
    params = j_smx.init_speechmix(jax.random.PRNGKey(1), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    tp = convert.params_from_jax(tree, tc)["speech_encoder"]
    rng = np.random.RandomState(11)
    wav = (rng.randn(2, 4000) * 0.1).astype(np.float32)
    wav[1, 3000:] = 0.0
    lens = np.array([4000, 3000], np.int32)
    fused = lambda m, c: dataclasses.replace(c.encoder,
                                             extractor_impl="fused")
    assert t_se._fused_extractor_ok(tc.encoder)
    out_conv = t_se.extract_features(tp, tc.encoder, _t(wav), _t(lens))
    out_fused = t_se.extract_features(tp, fused(tcfg, tc), _t(wav), _t(lens))
    ref = j_se.extract_features(params["speech_encoder"], fused(jcfg, jc),
                                jnp.asarray(wav), jnp.asarray(lens))
    assert out_fused.shape == out_conv.shape
    np.testing.assert_allclose(out_fused.numpy(), out_conv.numpy(), atol=1e-4)
    np.testing.assert_allclose(out_fused.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("impl", ["patches", "pairs", "taps"])
def test_extract_features_refuses_xla_reformulations(tiny, impl):
    _, tc, _, tp = tiny
    cfg = dataclasses.replace(tc.encoder, extractor_impl=impl)
    with pytest.raises(NotImplementedError, match="XLA reformulation"):
        t_se.extract_features(tp["speech_encoder"], cfg, torch.zeros(1, 4000))


# ---------------------------------------------------------------------------
# greedy generate with int8 cross K/V
# ---------------------------------------------------------------------------

def test_generate_greedy_kv_int8_token_exact():
    from test_torch_slice import _tree
    jc, tc = _tiny_cfgs()
    tree = _tree(jc, 0.3, seed=1)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    ref_tok, ref_len, ref_scores = j_gen.generate(
        jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(wav),
        jnp.asarray(lens), max_length=16, kv_int8=True, output_scores=True)
    tok, length, scores = t_gen.generate(
        convert.params_from_jax(tree, tc), tc, wav, lens, max_length=16,
        kv_int8=True, output_scores=True, device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    assert scores.shape == (16, 2, tc.decoder.vocab_size)
    np.testing.assert_array_equal(scores.argmax(-1).T[:, 0].numpy(),
                                  tok[:, 0].numpy())
    # the per-step scores are the JAX package's processed scores
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               atol=1e-4)
