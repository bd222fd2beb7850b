"""The head widths and model widths the TPU kernels take beyond the port's
first bodies, against the JAX package on the CPU.

The JAX package's attention kernels take any head width D (the fused-layout
kernels block heads by (hb * D) % 128 == 0 or take the whole row; the
decode kernel reads D from k's shape).  The port's kernels take every D
that is a multiple of 8 from 8 to 128; here their plain versions (what the
kernels compute, and what a CPU tensor runs) are held at D = 16 (the tiny
presets), 80 (wav2vec2-xls-r-1b, hubert-xlarge), 120 (XLS-R 2B) and 128
(t5-3b's d_kv) against:

- K1 / K7: ``flash_attention_fused_layout`` and ``_flash_bwd_fused_layout``
  in interpret mode, as tests/test_flash_attention.py runs them; the tiled
  plain versions too (attention_fwd_tiled_plain, attention_bwd_tiled_plain:
  the bf16 kernels' tiles, which at these widths sum over a head padded to
  64 or 128 columns with zeros, exact in every sum; the kernels' split of
  the head between two warpgroups at 128 changes no sum's order);
- K14 / K15: ``flash_attention_dropout`` and its ``jax.grad``, with JAX's
  mask (``_xla_dropout_mask``) fed to the port's explicit-mask versions, as
  tests/test_flash_dropout.py runs it;
- K4: ``decode_attention(..., force_pallas=True)`` in float32, bfloat16 and
  int8 codes, and the cluster body's split plain version.

Then a narrow model of XLS-R 1B's shape (two pre-LN layers of H = 640, 8
heads of 80, F = 2560, the LayerNorm extractor, from the XLS-R 1B
config.json fields through both packages' config_from_hf) with a BART of
bart-large's structure at 2 + 2 layers and the same heads, through
params_from_jax: the speech encoder's output, the logits, greedy tokens and
one f32 train step's loss and gradients.

Tolerances.  Attention float32 2e-4 absolute and relative (the JAX tests'
own); bfloat16 2^-6 of the largest reference magnitude (one bf16 rounding of
the probabilities and two of the output; tests/test_torch_attention_fwd_
split.py's rule).  K4 float32 1e-5, bfloat16 2e-2 (tests/
test_torch_decode.py's).  The model: hidden states, logits and loss 1e-4
absolute; gradients 1e-4 of each leaf's largest entry plus 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import convert as j_convert
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import speech_encoder as j_se
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.ops.pallas import decode_attention as j_da
from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import decode_attention as t_da
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from test_torch_train import _batch, _flat, _j, _t_batch
from torch_threads import one_torch_thread  # noqa: F401

WIDTHS = (16, 80, 120, 128)
HEADS = 4
F32_TOL = 2e-4
REL_BF16 = 2.0 ** -6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(d, tq=40, tk=None, seed=0):
    """q (2, tq, H, D), k, v, g; key lengths tk and tk - 9."""
    tk = tq if tk is None else tk
    rng = np.random.RandomState(seed)
    q = rng.randn(2, tq, HEADS, d).astype(np.float32)
    k, v = (rng.randn(2, tk, HEADS, d).astype(np.float32) for _ in range(2))
    g = rng.randn(2, tq, HEADS, d).astype(np.float32)
    mask = np.arange(tk)[None, :] < np.array([[tk], [tk - 9]])
    return q, k, v, g, mask


def _slab(a, dtype=torch.float32):
    b, t, h, d = a.shape
    return _t(a).to(dtype).reshape(b, t, h * d)


def _close(got, ref, what, dtype="float32"):
    got = got.float().numpy().reshape(np.shape(ref))
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert np.isfinite(got).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        err, limit = np.abs(got - ref).max(), REL_BF16 * np.abs(ref).max()
        assert err <= limit, f"{what}: {err} > {limit}"


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fak.pl, "pallas_call",
                        functools.partial(fak.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_fwd_matches_fused_layout_kernel(d, causal, interpret):
    """K1's plain and tiled plain versions against the Pallas kernel it
    replaces (interpret mode), float32."""
    q, k, v, _, mask = _inputs(d, seed=d)
    scale = d ** -0.5
    ref = fak.flash_attention_fused_layout(
        *(jnp.asarray(_slab(a).numpy()) for a in (q, k, v)),
        jnp.asarray(mask), heads=HEADS, scale=scale, causal=causal)
    assert ref is not None
    args = (*(_slab(a) for a in (q, k, v)), _t(mask), HEADS, scale, causal)
    _close(t_attn.attention_fwd_plain(*args), ref, f"plain D={d}")
    _close(t_attn.attention_fwd_tiled_plain(*args), ref, f"tiled D={d}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_attention_bwd_matches_fused_layout_kernel(d, causal, interpret):
    """K7's plain version, and its tiled plain version from the port's
    forward output and lse, against _flash_bwd_fused_layout (interpret
    mode), float32."""
    q, k, v, g, mask = _inputs(d, seed=d + 1)
    scale = d ** -0.5
    ref = fak._flash_bwd_fused_layout(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
        jnp.asarray(g), scale=scale, causal=causal)
    assert ref is not None
    slabs = [_slab(a) for a in (q, k, v)]
    out, lse = t_attn.attention_fwd_plain(*slabs, _t(mask), HEADS, scale,
                                          causal, return_lse=True)
    plain = t_attn.attention_bwd_plain(*slabs, _t(mask), _slab(g), HEADS,
                                       scale, causal)
    tiled = t_attn.attention_bwd_tiled_plain(*slabs, _t(mask), out, lse,
                                             _slab(g), HEADS, scale, causal)
    for name, p, t, r in zip(("dq", "dk", "dv"), plain, tiled, ref):
        _close(p, r, f"{name} plain D={d}")
        _close(t, r, f"{name} tiled D={d}")


@pytest.mark.parametrize("d", WIDTHS)
def test_attention_bf16_tiles_match_reference(d):
    """The bf16 kernels' tiles at the new widths: attention_fwd_tiled_plain
    and attention_bwd_tiled_plain in bfloat16 against the JAX reference
    forward and backward in float32 (2^-6 of the largest magnitude)."""
    q, k, v, g, mask = _inputs(d, tq=100, seed=d + 2)
    scale = d ** -0.5
    ref = fak._attn_ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(mask), scale, False)
    slabs = [_slab(a, torch.bfloat16) for a in (q, k, v)]
    out, lse = t_attn.attention_fwd_tiled_plain(
        *slabs, _t(mask), HEADS, scale, False, return_lse=True)
    _close(out, ref, f"forward D={d}", "bfloat16")
    refg = fak._attn_ref_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                             jnp.asarray(mask), scale, False, jnp.asarray(g))
    got = t_attn.attention_bwd_tiled_plain(
        *slabs, _t(mask), out, lse, _slab(g, torch.bfloat16), HEADS, scale)
    for name, o, r in zip(("dq", "dk", "dv"), got, refg):
        _close(o, r, f"{name} D={d}", "bfloat16")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_dropout_attention_matches_jax(d, causal):
    """K14 / K15's plain versions given JAX's mask against
    flash_attention_dropout and its jax.grad, float32."""
    seed, rate = 5, 0.2
    q, k, v, g, mask = _inputs(d, seed=d + 3)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jm = jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = fak.flash_attention_dropout(q_, k_, v_, jm, seed, scale, causal,
                                          rate)
        return jnp.sum(out * jg)
    ref = fak.flash_attention_dropout(jq, jk, jv, jm, seed, scale, causal,
                                      rate)
    refg = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    b, t = q.shape[:2]
    dmask = _t(np.array(fak._xla_dropout_mask(seed, (b, HEADS, t, t), rate),
                        np.float32))
    slabs = [_slab(a) for a in (q, k, v)]
    out = t_attn.attention_fwd_plain(*slabs, _t(mask), HEADS, scale, causal,
                                     dmask=dmask)
    _close(out, ref, f"K14 D={d}")
    got = t_attn.attention_bwd_plain(*slabs, _t(mask), _slab(g), HEADS,
                                     scale, causal, dmask)
    for name, o, r in zip(("dq", "dk", "dv"), got, refg):
        _close(o, r, f"K15 {name} D={d}")


@pytest.mark.parametrize("d", WIDTHS)
def test_ports_mask_tiles_match_attention_dropout(d):
    """With the port's own mask, the tiled versions give what the port's
    K14 / K15 give on the CPU at the new widths."""
    rate, key = 0.1, t_drop.DropoutKey.from_seed(d)
    q, k, v, g, mask = _inputs(d, tq=70, seed=d + 4)
    scale = d ** -0.5
    args = (*(_slab(a) for a in (q, k, v)), _t(mask), HEADS, scale, False)
    ref, ref_lse = t_attn.attention_dropout_fwd(*args, key, rate,
                                                return_lse=True)
    dmask = t_drop.attention_mask_plain(key, 2, HEADS, 70, 70, rate)
    out, lse = t_attn.attention_fwd_tiled_plain(*args, True, dmask)
    _close(out, ref.numpy(), f"forward D={d}")
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = t_attn.attention_dropout_bwd(*args[:4], ref, ref_lse, _slab(g),
                                        HEADS, scale, False, key, rate)
    got = t_attn.attention_bwd_tiled_plain(*args[:4], out, lse, _slab(g),
                                           HEADS, scale, False, dmask)
    for name, o, r in zip(("dq", "dk", "dv"), got, want):
        _close(o, r.numpy(), f"{name} D={d}")


def _quant(x):
    amax = np.abs(x).max(axis=-1)
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    codes = np.clip(np.round(x / scale[..., None]), -127, 127)
    return codes.astype(np.int8), scale


def _decode_inputs(d, t, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(4, 1, HEADS, d).astype(np.float32)
    k, v = (rng.randn(4, t, HEADS, d).astype(np.float32) for _ in range(2))
    valid = np.array([t, t // 2, t // 3, 1])
    return q, k, v, np.arange(t)[None, :] < valid[:, None]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", WIDTHS)
def test_decode_attention_matches_pallas(d, kind):
    """K4's plain version against the Pallas decode kernel (force_pallas),
    float K/V in float32 and bfloat16 and int8 codes with scales."""
    t = 96
    q, k, v, mask = _decode_inputs(d, t, d)
    scale, kw_j, kw_t = d ** -0.5, {}, {}
    if kind == "int8":
        (k, ks), (v, vs) = _quant(k), _quant(v)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    jd, td = ((jnp.bfloat16, torch.bfloat16) if kind == "bfloat16"
              else (jnp.float32, torch.float32))
    ref = j_da.decode_attention(
        jnp.asarray(q).astype(jd),
        *(jnp.asarray(a) if kind == "int8" else jnp.asarray(a).astype(jd)
          for a in (k, v)),
        jnp.asarray(mask), scale=scale, num_heads=HEADS, force_pallas=True,
        **kw_j)
    out = t_da.decode_attention(
        _t(q).to(td), *(_t(a) if kind == "int8" else _t(a).to(td)
                        for a in (k, v)),
        _t(mask), scale=scale, num_heads=HEADS, **kw_t)
    assert out.dtype == td and out.shape == (4, 1, HEADS, d)
    tol = 2e-2 if kind == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("d", WIDTHS)
def test_decode_split_plain_matches_plain(d):
    """The cluster body's decomposition at the new widths (400 keys, 4
    shares, beams of 4 sharing K/V) against the untiled plain version."""
    t = 400
    q, k, v, mask = _decode_inputs(d, t, d + 1)
    q = np.repeat(q, 4, axis=0)   # (16, 1, H, D): 4 beams a row
    args = dict(scale=d ** -0.5, num_heads=HEADS)
    plain = t_da.decode_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                        **args)
    split = t_da.decode_attention_split_plain(_t(q), _t(k), _t(v), _t(mask),
                                              **args)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [8, 16, 24, 64, 80, 120, 128])
def test_head_widths_the_kernels_take(d):
    assert t_attn.check_head_dim("K1", HEADS * d, HEADS) == d


@pytest.mark.parametrize("width,heads", [(4 * 20, 4), (4 * 136, 4),
                                         (4 * 4, 4), (130, 4), (0, 4)])
def test_head_widths_the_kernels_refuse(width, heads):
    with pytest.raises(ValueError, match="multiple of 8 in \\[8, 128\\]"):
        t_attn.check_head_dim("K1", width, heads)


# ---------------------------------------------------------------------------
# wav2vec2-xls-r-1b
# ---------------------------------------------------------------------------

def test_xls_r_config_from_hf_matches_jax():
    """Both packages' config_from_hf read the XLS-R 1B fields alike: 48
    pre-LN layers, H = 1280, 16 heads of 80, F = 5120."""
    j = j_convert.config_from_hf(dict(convert.XLS_R_1B_CONFIG))
    t = convert.config_from_hf(dict(convert.XLS_R_1B_CONFIG))
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.keys() <= td.keys()
    for name, value in jd.items():
        assert td[name] == value, name
    assert (t.num_layers, t.hidden_size, t.num_heads, t.ffn_dim) == (
        48, 1280, 16, 5120)
    assert t.hidden_size // t.num_heads == 80
    assert t.do_stable_layer_norm and t.feat_extract_norm == "layer"
    assert t.conv_bias and t.conv_dims == (512,) * 7


def _narrow_cfgs():
    """XLS-R 1B's fields narrowed to two layers of H = 640 (8 heads of 80,
    F = 2560; a 128-channel extractor keeps the CPU run short) through each
    package's config_from_hf, with a bart-large-structured BART of the same
    heads at 2 + 2 layers and the byte vocabulary."""
    fields = dict(convert.XLS_R_1B_CONFIG, hidden_size=640,
                  num_attention_heads=8, intermediate_size=2560,
                  num_hidden_layers=2, conv_dim=[128] * 7,
                  apply_spec_augment=False, layerdrop=0.0)

    def build(mod, conv):
        enc = conv.config_from_hf(dict(fields))
        dec = dataclasses.replace(
            mod.SEQ2SEQ_PRESETS["bart-large"], vocab_size=384,
            hidden_size=640, num_heads=8, ffn_dim=2560, encoder_layers=2,
            decoder_layers=2, max_positions=512, max_length=32)
        return mod.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2)
    return build(jcfg, j_convert), build(tcfg, convert)


@pytest.fixture(scope="module")
def narrow():
    jc, tc = _narrow_cfgs()
    assert tc.encoder.hidden_size // tc.encoder.num_heads == 80
    assert tc.decoder.per_head_dim == 80
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(3)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "decoder" in name and "embed_positions" in name:
            return (rng.randn(*a.shape) * 3.0).astype(np.float32)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * 0.05).astype(np.float32)
        return a
    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    return jc, tc, tree, convert.params_from_jax(tree, tc)


def test_narrow_speech_encoder_matches_jax(narrow):
    jc, tc, tree, params = narrow
    batch = _batch(rows=2)
    ref = j_se.speech_encoder_apply(
        _j(tree["speech_encoder"]), jc.encoder,
        jnp.asarray(batch["input_values"]), jnp.asarray(batch["lengths"]))
    tb = _t_batch(batch)
    out = t_se.speech_encoder_apply(params["speech_encoder"], tc.encoder,
                                    tb["input_values"], tb["lengths"])
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(ref["last_hidden_state"]), rtol=0,
                               atol=1e-4)


def test_narrow_logits_match_jax(narrow):
    jc, tc, tree, params = narrow
    batch = _batch(rows=2)
    ref = j_smx.speechmix_forward(
        _j(tree), jc, jnp.asarray(batch["input_values"]),
        jnp.asarray(batch["lengths"]), labels=jnp.asarray(batch["labels"]))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(params, tc, tb["input_values"],
                                  tb["lengths"], labels=tb["labels"])
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]),
                               rtol=0, atol=1e-4)


def test_narrow_greedy_tokens_match_jax(narrow):
    """Greedy generate token-exact: the decoder's cached steps run K4's
    plain version at D = 80."""
    jc, tc, tree, params = narrow
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, 8000) * 0.1).astype(np.float32)
    wav[1, 6000:] = 0.0
    lens = np.array([8000, 6000], np.int32)
    ref_tok, ref_len = j_gen.generate(_j(tree), jc, jnp.asarray(wav),
                                      jnp.asarray(lens), max_length=12)
    tok, length = t_gen.generate(params, tc, wav, lens, max_length=12,
                                 device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))


def test_narrow_loss_and_gradients_match_jax(narrow):
    """One f32 step's loss and every gradient leaf against jax.grad of the
    JAX package's forward: K1 / K7 at D = 80 and the FFNs at H = 640 in
    their plain versions."""
    jc, tc, tree, _ = narrow
    batch = _batch(rows=2)

    def j_loss(p):
        return j_smx.speechmix_forward(
            p, jc, jnp.asarray(batch["input_values"]),
            jnp.asarray(batch["lengths"]),
            labels=jnp.asarray(batch["labels"]))["loss"]
    j_value, j_grads = jax.value_and_grad(j_loss)(_j(tree))
    leaves = convert.params_from_jax(tree, tc)
    from speechmix_tpu_torch.training.freezing import tree_map
    leaves = tree_map(lambda p: p.requires_grad_(), leaves)
    tb = _t_batch(batch)
    loss = t_smx.speechmix_forward(leaves, tc, tb["input_values"],
                                   tb["lengths"], labels=tb["labels"])["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=0,
                               atol=1e-4)
    grads = tree_map(lambda p: (p.grad if p.grad is not None
                                else torch.zeros_like(p)), leaves)
    got = _flat(convert.tree_to_jax_layout(grads))
    want = _flat(j_grads)
    assert got.keys() == want.keys()
    for path, ref in want.items():
        limit = 1e-4 * np.abs(ref).max() + 1e-6
        err = np.abs(got[path] - np.asarray(ref)).max()
        assert err <= limit, f"{path}: {err} > {limit}"
