"""The adapter, self and gan variants of the port against the JAX package,
float32 on the CPU: the loss and each named loss term, the logits, the full
gradient tree against jax.grad, the variants' static masks, the GAN's
alternating masks, four gan train steps with des_update=2 against the JAX
step, and the adapter variant's greedy and beam-4 generate token-exact.

Tolerances are those of test_torch_train.py: loss, loss terms and logits
1e-4 absolute; a gradient leaf 1e-4 of its largest magnitude plus 1e-7;
parameters after a step as test_torch_adafactor.py holds them.  The
discriminator's kernel is drawn at std 1e-3, so that its logits on the Gram
features (sums over the positions of products of LayerNorm outputs) are of
order one and its sigmoid does not saturate.
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
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.ops import layers as j_layers
from speechmix_tpu.training import freezing as j_freezing
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.training import freezing as t_freezing
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_adafactor import _assert_params_close
from test_torch_slice import _tree as _generate_tree
from test_torch_train import (LR, _assert_trees_close, _batch, _cfgs, _flat,
                              _j, _t_batch, _tree)
from test_torch_unfreeze import _assert_masks_equal, _trees
from torch_threads import one_torch_thread  # noqa: F401

TERMS = {"eed": (), "adapter": (),
         "self": ("ce_loss", "kld_loss", "mse_loss"),
         "gan": ("voice_enc_loss", "voice_dec_loss", "nlp_enc_loss",
                 "nlp_dec_loss")}


def _variant_tree(jc):
    tree = _tree(jc)
    if "discriminator" in tree:
        rng = np.random.RandomState(7)
        kernel = tree["discriminator"]["kernel"]
        tree["discriminator"] = dict(
            tree["discriminator"],
            kernel=(rng.randn(*kernel.shape) * 1e-3).astype(np.float32))
    return tree


def _text_batch(rows=4, seed=3):
    """_batch() with ground-truth text ids of their own length, padded (the
    pad id 1) in two rows."""
    batch = _batch(rows)
    rng = np.random.RandomState(seed)
    text = rng.randint(3, 384, size=(rows, 10)).astype(np.int32)
    text[1, 7:] = 1
    text[2, 4:] = 1
    batch["text_input_ids"] = text
    return batch


def _forwards(variant, batch, tree):
    jc, tc = _cfgs(variant)
    text = batch.get("text_input_ids")
    ref = j_smx.speechmix_forward(
        _j(tree), jc, jnp.asarray(batch["input_values"]),
        jnp.asarray(batch["lengths"]), labels=jnp.asarray(batch["labels"]),
        text_input_ids=None if text is None else jnp.asarray(text))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(
        convert.params_from_jax(tree, tc), tc, tb["input_values"],
        tb["lengths"], labels=tb["labels"],
        text_input_ids=tb.get("text_input_ids"))
    return ref, out


@pytest.mark.parametrize("tree_of", ["adapter", "gan", "pre-ln"])
def test_tree_to_jax_layout_inverts_params_from_jax(tree_of):
    """The adapters (stacked per side in JAX, lists in the port), the
    discriminator and the pre-LN encoder's leaves survive the round
    trip."""
    if tree_of == "pre-ln":
        tree, params = _trees(True)
    else:
        jc, tc = _cfgs(tree_of)
        tree = _tree(jc)
        params = convert.params_from_jax(tree, tc)
        key = "adapters" if tree_of == "adapter" else "discriminator"
        assert key in params and key in tree
    if tree_of == "adapter":
        assert len(params["adapters"]["decoder"]) == 2
    back = _flat(convert.tree_to_jax_layout(params))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for path, ref in want.items():
        np.testing.assert_array_equal(back[path], ref, err_msg=path)


def test_seq2seq_apply_with_adapters_matches_jax():
    """seq2seq_apply on token ids with adapters and output_hidden_states,
    and again from the encoder's outputs (encoder_outputs=): logits and
    every encoder and decoder hidden state."""
    jc, tc = _cfgs("adapter")
    tree = _tree(jc)
    params = convert.params_from_jax(tree, tc)
    rng = np.random.RandomState(11)
    ids = rng.randint(3, 384, size=(2, 9)).astype(np.int32)
    ids[1, 6:] = 1
    dec_ids = rng.randint(3, 384, size=(2, 5)).astype(np.int32)
    jp = _j(tree)
    ref = j_s2s.seq2seq_apply(
        jp["nlp"], jc.decoder, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(ids != 1),
        decoder_input_ids=jnp.asarray(dec_ids), output_hidden_states=True,
        adapters=jp["adapters"])
    t_ids, t_dec = torch.from_numpy(ids).long(), torch.from_numpy(dec_ids)
    out = t_s2s.seq2seq_apply(
        params["nlp"], tc.decoder, input_ids=t_ids,
        attention_mask=t_ids != 1, decoder_input_ids=t_dec.long(),
        output_hidden_states=True, adapters=params["adapters"])
    enc = t_s2s.encode(params["nlp"], tc.decoder, input_ids=t_ids,
                       attention_mask=t_ids != 1,
                       adapters=params["adapters"])
    again = t_s2s.seq2seq_apply(
        params["nlp"], tc.decoder, decoder_input_ids=t_dec.long(),
        encoder_outputs=enc, adapters=params["adapters"])
    for name in ("logits", "encoder_hidden_states", "decoder_hidden_states"):
        np.testing.assert_allclose(out[name].detach().numpy(),
                                   np.asarray(ref[name]), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert out["decoder_hidden_states"].shape == (3, 2, 5, 64)
    assert torch.equal(again["logits"], out["logits"])


def test_kld_and_bce_match_jax():
    """kld_batchmean with teacher probabilities that are exactly 0 (torch's
    KLDiv: those terms are 0) and bce_with_logits at large logits."""
    rng = np.random.RandomState(5)
    student = rng.randn(3, 5, 11).astype(np.float32) * 3
    teacher = rng.randn(3, 5, 11).astype(np.float32) * 3
    teacher[0, :, 4] = -np.inf
    got = t_layers.kld_batchmean(torch.from_numpy(student),
                                 torch.from_numpy(teacher)).item()
    want = float(j_layers.kld_batchmean(jnp.asarray(student),
                                        jnp.asarray(teacher)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5)
    logits = np.array([-80.0, -3.0, 0.0, 2.5, 90.0], np.float32)
    for target in (0.0, 1.0):
        targets = np.full_like(logits, target)
        got = t_layers.bce_with_logits(torch.from_numpy(logits),
                                       torch.from_numpy(targets)).item()
        want = float(j_layers.bce_with_logits(jnp.asarray(logits),
                                              jnp.asarray(targets)))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("variant,text", [
    ("adapter", False), ("self", True), ("gan", True), ("gan", False)])
def test_loss_terms_and_logits_match_jax(variant, text):
    """gan without text ids takes the labels (-100 as pad) as its text."""
    jc, _ = _cfgs(variant)
    batch = _text_batch() if text else _batch()
    ref, out = _forwards(variant, batch, _variant_tree(jc))
    for name in ("loss",) + TERMS[variant]:
        np.testing.assert_allclose(out[name].item(), float(ref[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=0, atol=1e-4)
    if variant == "self":
        assert out["loss"].item() == pytest.approx(
            sum(out[n].item() for n in TERMS["self"]), abs=1e-5)
    if variant == "gan":     # the BCE terms are not saturated
        assert all(1e-3 < out[n].item() < 5.0 for n in TERMS["gan"])


@pytest.mark.parametrize("variant", ["adapter", "self", "gan"])
def test_gradient_tree_matches_jax_grad(variant):
    jc, tc = _cfgs(variant)
    tree, batch = _variant_tree(jc), _text_batch()

    def loss_fn(p):
        return j_smx.speechmix_forward(
            p, jc, jnp.asarray(batch["input_values"]),
            jnp.asarray(batch["lengths"]),
            labels=jnp.asarray(batch["labels"]),
            text_input_ids=jnp.asarray(batch["text_input_ids"]))["loss"]
    ref = jax.jit(jax.grad(loss_fn))(_j(tree))

    params = convert.params_from_jax(tree, tc)
    leaves = t_trainer.tree_map(lambda p: p.requires_grad_(), params)
    tb = _t_batch(batch)
    loss = t_smx.speechmix_forward(
        leaves, tc, tb["input_values"], tb["lengths"], labels=tb["labels"],
        text_input_ids=tb["text_input_ids"])["loss"]
    flat = [leaf for _, leaf in t_trainer.tree_paths(leaves)]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grad_tree = t_trainer.tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(grads)), leaves)
    _assert_trees_close(grad_tree, ref, rel=1e-4, atol=1e-7)


@pytest.mark.parametrize("variant,fixed_parameters", [
    ("eed", False), ("ed", False), ("fixed", False), ("adapter", False),
    ("self", False), ("gan", False), ("adapter", True), ("gan", True)])
def test_variant_masks_match_jax(variant, fixed_parameters):
    jc, tc = _cfgs(variant)
    jc = dataclasses.replace(jc, fixed_parameters=fixed_parameters)
    tc = dataclasses.replace(tc, fixed_parameters=fixed_parameters)
    tree = _tree(jc)
    params = convert.params_from_jax(tree, tc)
    for flags in ((False, True), (True, False)):
        _assert_masks_equal(
            t_freezing.variant_trainable_mask(params, tc, *flags),
            j_freezing.variant_trainable_mask(tree, jc, *flags))
    mask = t_freezing.variant_trainable_mask(params, tc)
    if variant == "adapter":
        assert all(m == 1.0 for _, m in t_freezing.tree_paths(
            mask["adapters"])) or fixed_parameters
        assert all(m == 0.0 for _, m in t_freezing.tree_paths(
            mask["nlp"]["decoder"]["layers"]))


@pytest.mark.parametrize("des_update", [1, 2, 3])
def test_gan_alternating_masks_match_jax(des_update):
    jc, tc = _cfgs("gan")
    tree = _tree(jc)
    params = convert.params_from_jax(tree, tc)
    for step in range(6):
        mask = t_freezing.gan_alternating_masks(params, step, des_update)
        _assert_masks_equal(mask, j_freezing.gan_alternating_masks(
            tree, jnp.int32(step), des_update))
        disc_step = (step // des_update) % 2 == 1
        assert mask["discriminator"]["kernel"] == float(disc_step)
        assert mask["enc_to_dec_proj"]["kernel"] == float(not disc_step)


def test_four_gan_steps_match_jax():
    """des_update=2: steps 0 and 1 train the generator (the discriminator
    bit-unchanged), steps 2 and 3 the discriminator (everything else
    bit-unchanged); each against the JAX step."""
    jc, tc = _cfgs("gan")
    jc = dataclasses.replace(jc, gan_discriminator_update_every=2)
    tc = dataclasses.replace(tc, gan_discriminator_update_every=2)
    tree, batch = _variant_tree(jc), _text_batch()
    kw = dict(learning_rate=LR, warmup_steps=0, max_grad_norm=1.0,
              grad_accum=2, dropout=False)
    j_tc = j_trainer.TrainConfig(use_flash=False, **kw)
    t_tc = t_trainer.TrainConfig(**kw)
    j_params = _j(tree)
    j_state = j_trainer.TrainState(
        j_params, j_trainer.make_optimizer(j_tc).init(j_params),
        jnp.zeros((), jnp.int32))
    j_step = j_trainer.make_train_step(jc, j_tc, j_params)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = convert.params_from_jax(tree, tc)
    t_state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_tc).init(params), 0)
    t_step = t_trainer.make_train_step(tc, t_tc, params, device="cpu")
    tb = _t_batch(batch)
    for step in range(4):
        before = {path: p.clone() for path, p in
                  t_trainer.tree_paths(params)}
        j_state, j_metrics = j_step(j_state, j_batch, jnp.float32(0.0))
        t_state, t_metrics = t_step(t_state, tb)
        for name in ("loss", "grad_norm"):
            ref = float(j_metrics[name])
            assert abs(t_metrics[name].item() - ref) <= 1e-4 * abs(ref) + \
                1e-6, (step, name, t_metrics[name].item(), ref)
        assert set(TERMS["gan"]) <= t_metrics.keys()
        _assert_params_close(t_state.params, j_state.params, step + 1)
        disc_step = step >= 2
        for path, p in t_trainer.tree_paths(params):
            frozen = (path.startswith("nlp") or
                      path.startswith("discriminator") != disc_step or
                      path.endswith("masked_spec_embed"))
            if frozen:
                assert torch.equal(p, before[path]), (step, path)
            elif "k_proj" not in path or "kernel" in path:
                assert not torch.equal(p, before[path]), (step, path)


@pytest.mark.parametrize("variant",
                         ["eed", "fixed", "ed", "adapter", "self", "gan"])
def test_default_train_step_runs_for_every_variant(variant):
    """make_train_step(cfg, TrainConfig()): Adafactor, dropout on.  The loss
    is finite, the leaves the variant freezes stay bit-unchanged and the
    others move."""
    jc, tc = _cfgs(variant)
    params = convert.params_from_jax(_variant_tree(jc), tc)
    step = t_trainer.make_train_step(tc, t_trainer.TrainConfig(
        warmup_steps=0), params, device="cpu")
    state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_trainer.TrainConfig()).init(
            params), 0)
    before = {path: p.clone() for path, p in t_trainer.tree_paths(params)}
    state, metrics = step(state, _t_batch(_text_batch()))
    assert np.isfinite(metrics["loss"].item())
    assert set(TERMS.get(variant, ())) <= metrics.keys()
    mask = t_freezing.variant_trainable_mask(params, tc)
    frozen = {path for path, m in t_trainer.tree_paths(mask) if m == 0}
    if variant == "gan":   # step 0 trains the generator only
        frozen |= {path for path in before if path.startswith(
            "discriminator")}
    # without a gradient: SpecAugment is off in tiny-speech, and ed has no
    # text-encoder pass
    unused = ("speech_encoder/masked_spec_embed",) + (
        ("nlp/encoder",) if variant == "ed" else ())
    for path, p in t_trainer.tree_paths(params):
        if path in frozen or path.startswith(unused):
            assert torch.equal(p, before[path]), path
        elif "k_proj" not in path:
            assert not torch.equal(p, before[path]), path


@pytest.mark.parametrize("num_beams", [1, 4])
def test_adapter_generate_token_exact(num_beams):
    mk = lambda m: m.SpeechMixConfig(
        encoder=m.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=m.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2,
        variant="adapter")
    jc, tc = mk(jcfg), mk(tcfg)
    tree = _generate_tree(jc, 0.3, seed=1)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    kw = dict(max_length=12, num_beams=num_beams)
    ref_tok, ref_len = j_gen.generate(
        jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(wav),
        jnp.asarray(lens), **kw)
    params = convert.params_from_jax(tree, tc)
    tok, length = t_gen.generate(params, tc, wav, lens, device="cpu", **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    # the adapters take part: without them the tokens differ
    eed = dataclasses.replace(tc, variant="eed")
    plain, _ = t_gen.generate(params, eed, wav, lens, device="cpu", **kw)
    assert not torch.equal(plain, tok)
