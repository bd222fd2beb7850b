"""Faults of the port found against the JAX package, each pinned:

- the ``ed`` variant's generate decodes from the projected speech states,
  with no text-encoder pass (greedy, greedy with int8 cross K/V, beam-4),
  token-exact against the JAX package in float32;
- the tied LM head gives the float32 product of the bfloat16 operands, not
  its bfloat16 rounding (``jnp.dot(..., preferred_element_type=f32)``);
- the fused blocks take the JAX package's gate: enough rows, H and F (Din
  and H) multiples of 128, one of the kernels' activations, unquantized
  weights; every other block runs the plain chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401


def _cfgs(variant):
    mk = lambda m: m.SpeechMixConfig(
        encoder=m.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=m.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2,
        variant=variant)
    return mk(jcfg), mk(tcfg)


def _tree(jc, seed=1, weight_std=0.3):
    """JAX init with the matrices redrawn at `weight_std` and the decoder's
    position table at 3.0, so the decoded tokens depend on the input."""
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "decoder" in name and "embed_positions" in name:
            return (rng.randn(*a.shape) * 3.0).astype(np.float32)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * weight_std).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


@pytest.fixture(scope="module")
def ed_setup():
    jc, tc = _cfgs("ed")
    tree = _tree(jc)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree, tc), wav, lens)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_int8=True),
    dict(num_beams=4, num_return_sequences=2, output_scores=True),
], ids=["greedy", "greedy-int8", "beam-4"])
def test_ed_generate_decodes_the_speech_states(ed_setup, kw):
    jc, tc, jp, tp, wav, lens = ed_setup
    ref = j_gen.generate(jp, jc, jnp.asarray(wav), jnp.asarray(lens),
                         max_length=16, **kw)
    out = t_gen.generate(tp, tc, wav, lens, max_length=16, device="cpu",
                         **kw)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    if "output_scores" in kw:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                                   rtol=0, atol=1e-4)
    # the tokens depend on the speech: not one sequence for both inputs
    assert not torch.equal(out[0][0], out[0][-1])


# ------------------------------------------------------------ tied head
# bf16 decode logits of the port against the JAX package's: both round the
# network's activations to bf16 at places that differ by one rounding here
# and there (relative 2^-8 each), over two layers; 0.05 of the largest
# logit's size leaves room above the measured ~0.01
TIED_HEAD_JAX_TOL = 0.05


def test_tied_head_logits_are_unrounded_f32_products(monkeypatch):
    jc, tc = _cfgs("eed")
    tree = _tree(jc, seed=2, weight_std=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.params_from_jax(tree, tc)
    bf16 = torch.bfloat16
    rng = np.random.RandomState(5)
    enc = (rng.randn(2, 9, tc.decoder.hidden_size)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    seen = []
    orig = getattr(t_s2s, "_tied_logits", None)

    def spy(x, w):
        seen.append((x, w))
        return orig(x, w)
    monkeypatch.setattr(t_s2s, "_tied_logits", spy, raising=False)
    jcache = j_s2s.init_decoder_cache(jp["nlp"], jc.decoder,
                                      jnp.asarray(enc, jnp.bfloat16), 2, 4,
                                      dtype=jnp.bfloat16)
    tcache = t_s2s.init_decoder_cache(tp["nlp"], tc.decoder,
                                      torch.from_numpy(enc).to(bf16), 2, 4,
                                      dtype=bf16)
    for ids in ([[2], [2]], [[40], [7]]):
        ids = np.array(ids, np.int32)
        jo = j_s2s.decode(jp["nlp"], jc.decoder, jnp.asarray(ids),
                          encoder_mask=jnp.asarray(mask), cache=jcache,
                          dtype=jnp.bfloat16)
        to = t_s2s.decode(tp["nlp"], tc.decoder, torch.from_numpy(ids),
                          torch.from_numpy(mask), tcache, dtype=bf16)
        jcache, tcache = jo["cache"], to["cache"]
        logits = to["logits"] - tp["nlp"]["final_logits_bias"]
        assert logits.dtype == torch.float32
        # a bf16 rounding of the product would leave every logit on the
        # bf16 grid
        representable = (logits == logits.to(bf16).float()).float().mean()
        assert representable.item() < 0.01, representable.item()
        ref = np.asarray(jo["logits"], np.float32)
        err = np.abs(to["logits"].numpy() - ref).max()
        assert err <= TIED_HEAD_JAX_TOL * np.abs(ref).max(), err
        # the f32 product of the head's own bf16 operands
        x, w = seen[-1]
        assert x.dtype == bf16 and w.dtype == bf16
        want = x.float() @ w.float().t()
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())


def test_generate_makes_the_tied_head_once(monkeypatch):
    """generate hands every decode step one head operand, made once."""
    jc, tc = _cfgs("eed")
    tp = convert.params_from_jax(_tree(jc), tc)
    heads = []
    orig = t_s2s.decode

    def spy(*args, lm_head=None, **kw):
        heads.append(lm_head)
        return orig(*args, lm_head=lm_head, **kw)
    monkeypatch.setattr(t_s2s, "decode", spy)
    wav = (np.random.RandomState(0).randn(1, 8000) * 0.1).astype(np.float32)
    t_gen.generate(tp, tc, wav, max_length=5, device="cpu",
                   dtype=torch.bfloat16)
    assert len(heads) == 5 and heads[0] is not None
    assert all(h is heads[0] for h in heads)


# ------------------------------------------------------------ the gate
_KERNEL_FUNCTIONS = ("ffn_res_ln_trainable", "ffn_fused_trainable",
                     "dense_res_ln_trainable", "ffn_dropout_res_ln_trainable",
                     "ffn_dropout_trainable",
                     "dense_dropout_res_ln_trainable")


@pytest.fixture
def kernel_calls(monkeypatch):
    calls = []
    for name in _KERNEL_FUNCTIONS:
        def spy(*args, _orig=getattr(t_ffn, name), _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)
        monkeypatch.setattr(t_ffn, name, spy)
    monkeypatch.setitem(t_layers.ACTIVATIONS, "tanh", torch.tanh)
    return calls


def _block(h, f, rows, dtype, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=0.03: torch.from_numpy(
        (rng.randn(*s) * sc).astype(np.float32))
    p1 = {"kernel": mk(h, f), "bias": mk(f)}
    p2 = {"kernel": mk(f, h), "bias": mk(h)}
    pd = {"kernel": mk(h, h), "bias": mk(h)}
    ln = {"scale": 1.0 + mk(h), "bias": mk(h)}
    x = mk(2, rows // 2, h, sc=1.0).to(dtype)
    return p1, p2, pd, ln, x


def _run_blocks(p1, p2, pd, ln, x, act):
    dt = x.dtype
    y = t_layers.ffn_residual_ln_apply(p1, p2, ln, x, act, dt)
    y = t_layers.dense_residual_ln_apply(pd, ln, y, x, dt)
    return y + t_layers.ffn_apply(p1, p2, y, act, dt)


@pytest.mark.parametrize("h,f,act,rows,kernels", [
    (64, 128, "gelu", 1024, False),     # narrow: the tiny presets' width
    (128, 192, "gelu", 1024, False),    # F not a multiple of 128
    (192, 256, "gelu", 1024, False),    # H (and Din) not a multiple of 128
    (128, 256, "tanh", 1024, False),    # an activation the kernels lack
    (768, 3072, "gelu", 1022, False),   # under the row gate
    (768, 3072, "gelu", 1024, True),    # the flagship's block
], ids=["H64", "F192", "H192", "tanh", "rows1022", "H768"])
def test_fused_blocks_take_the_reference_gate(kernel_calls, monkeypatch, h,
                                              f, act, rows, kernels):
    p1, p2, pd, ln, x = _block(h, f, rows, torch.bfloat16)
    out = _run_blocks(p1, p2, pd, ln, x, act)
    # the dense epilogue's gate looks at Din = H only
    dense = rows >= 1024 and h % 128 == 0
    want = (["ffn_res_ln_trainable", "dense_res_ln_trainable",
             "ffn_fused_trainable"] if kernels else
            ["dense_res_ln_trainable"] if dense else [])
    assert kernel_calls == want
    # the two routes compute one function: the plain chain (row gate
    # closed) gives the same values up to where each rounds to bf16 (the
    # kernels' plain versions once per block in f32, the chain after each
    # op): a few bf16 steps (2^-8 relative) of the largest output
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", 10 ** 9)
    ref = _run_blocks(p1, p2, pd, ln, x, act).float()
    err = (out.float() - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item()


def test_gate_refuses_quantized_weights():
    x = torch.zeros(2, 512, 128)
    p = {"kernel": torch.zeros(128, 256)}
    q = {"kernel_q": torch.zeros(128, 256, dtype=torch.int8),
         "scale": torch.ones(256)}
    assert t_layers._ffn_fused_eligible(p, {"kernel": torch.zeros(256, 128)},
                                        x, "gelu")
    assert not t_layers._ffn_fused_eligible(q, p, x, "gelu")
    assert not t_layers._ffn_fused_eligible(p, q, x, "gelu")
    assert t_layers._dense_fused_eligible({"kernel": torch.zeros(128, 128)},
                                          x)
    assert not t_layers._dense_fused_eligible(q, x)
