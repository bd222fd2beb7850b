"""The port's int8 weights and fused q/k/v against the JAX package's, on the
CPU in float32: quantize_weights / fuse_qkv_params / quantization_report on
the port's tree against params_from_jax of the JAX package's transforms
(codes bit-exact, scales exact), the int8 consumers (dense in both int8
modes, embed, the int8 tied head through seq2seq_apply) to 1e-5 relative,
and generate() on int8 and fused trees, token-exact against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.ops import layers as j_layers
from speechmix_tpu.utils import quantize as j_quant
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.training.freezing import tree_paths
from speechmix_tpu_torch.utils import quantize as t_quant
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401


def _cfgs(decoder="tiny-bart-bytes", variant="eed"):
    jc = jcfg.SpeechMixConfig(
        encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=jcfg.SEQ2SEQ_PRESETS[decoder], down_scale=2, variant=variant)
    tc = tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS[decoder], down_scale=2, variant=variant)
    return jc, tc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(got, want):
    """The same paths (jax.tree_util sorts the JAX trees' keys), dtypes and
    bits."""
    got, want = dict(tree_paths(got)), dict(tree_paths(want))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        assert torch.equal(a, want[path]), path


@pytest.mark.parametrize("decoder,variant,min_size", [
    ("tiny-bart-bytes", "eed", 4096), ("tiny-t5-bytes", "eed", 4096),
    ("tiny-bart-bytes", "adapter", 1024), ("tiny-bart-bytes", "gan", 4096)])
def test_quantize_and_fuse_match_jax(decoder, variant, min_size):
    jc, tc = _cfgs(decoder, variant)
    tree = _tree(jc, 0.3, seed=3)
    jq = _np_tree(j_quant.quantize_weights(
        jax.tree_util.tree_map(jnp.asarray, tree), min_size=min_size))
    want_q = convert.params_from_jax(jq, tc)
    got_q = t_quant.quantize_weights(convert.params_from_jax(tree, tc),
                                     min_size=min_size)
    assert_trees_equal(got_q, want_q)
    n_q, n_t = t_quant.quantization_report(got_q)
    assert (n_q, n_t) == j_quant.quantization_report(jq)
    assert n_q > 0.3 * n_t
    if decoder == "tiny-t5-bytes":   # bias-free stacks quantize by name
        block = got_q["nlp"]["decoder"]["layers"][0]
        assert "kernel_q" in block["self_attn"]["q_proj"]
        assert "bias" not in block["self_attn"]["q_proj"]
    for src_j, src_t in ((tree, convert.params_from_jax(tree, tc)),
                         (jq, got_q)):
        want = convert.params_from_jax(_np_tree(j_quant.fuse_qkv_params(
            jax.tree_util.tree_map(jnp.asarray, src_j))), tc)
        assert_trees_equal(t_quant.fuse_qkv_params(src_t), want)


def test_quantize_without_tied_head_and_small_min_size():
    jc, tc = _cfgs()
    tree = _tree(jc, 0.3, seed=4)
    kw = dict(min_size=10 ** 9, quantize_tied_head=False)
    got = t_quant.quantize_weights(convert.params_from_jax(tree, tc), **kw)
    assert t_quant.quantization_report(got)[0] == 0
    kw = dict(min_size=1, quantize_tied_head=False)
    want = convert.params_from_jax(_np_tree(j_quant.quantize_weights(
        jax.tree_util.tree_map(jnp.asarray, tree), **kw)), tc)
    got = t_quant.quantize_weights(convert.params_from_jax(tree, tc), **kw)
    assert_trees_equal(got, want)
    assert "embedding" in got["nlp"]["shared"]


@pytest.fixture
def int8_compute_off():
    yield
    j_layers.set_int8_dense_compute(False)
    t_layers.set_int8_dense_compute(False)


@pytest.mark.parametrize("int8_compute", [False, True])
def test_int8_dense_matches_jax(int8_compute, int8_compute_off):
    rng = np.random.RandomState(0)
    p = {"kernel": rng.randn(96, 40).astype(np.float32) * 0.2,
         "bias": rng.randn(40).astype(np.float32)}
    jq = _np_tree(j_quant.quantize_weights(
        {"proj": jax.tree_util.tree_map(jnp.asarray, p)}, min_size=1))
    tq = {k: torch.from_numpy(np.asarray(v)) for k, v in jq["proj"].items()}
    x = rng.randn(3, 5, 96).astype(np.float32)
    x[1, 2] = 0.0                      # a row of zeros: the scale's floor
    j_layers.set_int8_dense_compute(int8_compute)
    t_layers.set_int8_dense_compute(int8_compute)
    want = np.asarray(j_layers.dense(
        jax.tree_util.tree_map(jnp.asarray, jq["proj"]), jnp.asarray(x)))
    got = t_layers.dense(tq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_int8_matmul_exact():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randint(-127, 128, (5, 13)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (13, 7)).astype(np.int8))
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    got = t_layers.int8_matmul(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_embed_matches_jax():
    rng = np.random.RandomState(2)
    table = rng.randn(50, 24).astype(np.float32)
    jq = _np_tree(j_quant.quantize_weights(
        {"shared": {"embedding": jnp.asarray(table)}}, min_size=1))["shared"]
    ids = rng.randint(0, 50, (3, 7))
    want = np.asarray(j_layers.embed(
        jax.tree_util.tree_map(jnp.asarray, jq), jnp.asarray(ids)))
    got = t_layers.embed({k: torch.from_numpy(np.asarray(v))
                          for k, v in jq.items()}, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("decoder", ["tiny-bart-bytes", "tiny-t5-bytes"])
def test_int8_seq2seq_apply_matches_jax(decoder):
    """The int8 embedding lookups, int8 denses and the int8 tied head (its
    f32 product with per-row scales) through the teacher-forced pass."""
    jc, tc = _cfgs(decoder)
    tree = _tree(jc, 0.3, seed=5)
    jq = j_quant.quantize_weights(jax.tree_util.tree_map(jnp.asarray, tree))
    tq = convert.params_from_jax(_np_tree(jq), tc)
    assert "embedding_q" in tq["nlp"]["shared"]
    rng = np.random.RandomState(6)
    ids = rng.randint(3, 300, (2, 9))
    dec_ids = rng.randint(3, 300, (2, 6))
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    want = j_s2s.seq2seq_apply(
        jq["nlp"], jc.decoder, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask),
        decoder_input_ids=jnp.asarray(dec_ids))["logits"]
    got = t_s2s.seq2seq_apply(
        tq["nlp"], tc.decoder, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask),
        decoder_input_ids=torch.from_numpy(dec_ids))["logits"]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _wav():
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    return wav, np.array([16000, 11000], np.int32)


@pytest.mark.parametrize("decoder,tree_kind,mode", [
    ("tiny-bart-bytes", "int8", "greedy"),
    ("tiny-bart-bytes", "int8", "greedy-int8"),
    ("tiny-bart-bytes", "fused", "greedy-int8"),
    ("tiny-bart-bytes", "int8+fused", "beam-4"),
    ("tiny-t5-bytes", "int8+fused", "greedy")])
def test_generate_on_int8_and_fused_trees_matches_jax(decoder, tree_kind,
                                                      mode):
    jc, tc = _cfgs(decoder)
    tree = jax.tree_util.tree_map(jnp.asarray, _tree(jc, 0.3, seed=1))
    if "int8" in tree_kind:
        tree = j_quant.quantize_weights(tree)
    if "fused" in tree_kind:
        tree = j_quant.fuse_qkv_params(tree)
    params = convert.params_from_jax(_np_tree(tree), tc)
    kwargs = {"greedy": {}, "greedy-int8": {"kv_int8": True},
              "beam-4": {"num_beams": 4}}[mode]
    wav, lens = _wav()
    want = j_gen.generate(tree, jc, jnp.asarray(wav), jnp.asarray(lens),
                          max_length=12, **kwargs)
    got = t_gen.generate(params, tc, wav, lens, max_length=12, device="cpu",
                         **kwargs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
