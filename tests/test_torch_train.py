"""The port's deterministic training slice against the JAX package, float32
on the CPU: speechmix_forward (loss and logits), the full gradient tree
against jax.grad leaf by leaf, and three AdamW train steps with gradient
accumulation against the JAX package's jitted step.

Tiny configuration: tiny-speech cut to 2 layers + tiny-bart-bytes (2 + 2
layers, width 64), matrices redrawn at std 0.1 so that gradients are not
vanishingly small.  Both sides get the same numpy inputs; the JAX side runs
its XLA path.  The port runs on the CPU, where its kernel wrappers run their
plain versions; with the row gate lowered to 1 every FFN, dense epilogue and
attention of the slice goes through the kernels' differentiable functions
and their hand-written backward formulas.

Tolerances.  Loss and logits: 1e-4 absolute.  A gradient leaf: 1e-4 of the
leaf's largest reference magnitude (plus 1e-7).  A parameter after a step:
1e-4 of its largest magnitude plus 2e-6.  Attention key biases have a
gradient that is zero in exact arithmetic (the softmax ignores a shift of all
logits of a row); Adam divides their rounding noise by its own size, so after
a step these leaves are only held to the learning rate per step taken.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.training import trainer as t_trainer
from torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3


def _cfgs(variant):
    def build(mod):
        enc = dataclasses.replace(mod.SPEECH_ENCODER_PRESETS["tiny-speech"],
                                  num_layers=2)
        return mod.SpeechMixConfig(
            encoder=enc, decoder=mod.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
            down_scale=2, variant=variant)
    return build(jcfg), build(tcfg)


def _tree(jc, seed=1):
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _batch(rows=4, label_len=12, seed=0):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(rows, 8000) * 0.1).astype(np.float32)
    lens = np.array([8000, 6100, 8000, 7000][:rows], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    labels = rng.randint(3, 384, size=(rows, label_len)).astype(np.int32)
    labels[1, 9:] = -100
    labels[3 % rows, 5:] = -100
    return {"input_values": wav, "lengths": lens, "labels": labels}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.issubdtype(np.asarray(v).dtype, np.integer)
        and k != "example_mask" else np.asarray(v).dtype))
        for k, v in batch.items()}


def _flat(tree):
    """{path: array} of a JAX-layout tree."""
    return {jax.tree_util.keystr(kp): np.asarray(leaf) for kp, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(port_tree, jax_tree, rel, atol, noise_atol=None):
    got = _flat(convert.tree_to_jax_layout(port_tree))
    want = _flat(jax_tree)
    assert got.keys() == want.keys()
    for path, ref in want.items():
        limit = rel * np.abs(ref).max() + atol
        if noise_atol is not None and "k_proj" in path and "bias" in path:
            limit = noise_atol
        err = np.abs(got[path] - ref).max()
        assert got[path].shape == ref.shape, path
        assert err <= limit, f"{path}: {err} > {limit}"


def test_tree_to_jax_layout_inverts_params_from_jax():
    """Stacked layers, conv kernel layout and every leaf, masked_spec_embed
    included, survive the round trip."""
    jc, tc = _cfgs("eed")
    tree = _tree(jc)
    back = _flat(convert.tree_to_jax_layout(convert.params_from_jax(tree, tc)))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for path, ref in want.items():
        np.testing.assert_array_equal(back[path], ref, err_msg=path)


@pytest.mark.parametrize("variant", ["eed", "fixed", "ed"])
def test_forward_loss_and_logits(variant):
    jc, tc = _cfgs(variant)
    tree, batch = _tree(jc), _batch()
    ref = j_smx.speechmix_forward(
        _j(tree), jc, jnp.asarray(batch["input_values"]),
        jnp.asarray(batch["lengths"]), labels=jnp.asarray(batch["labels"]))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(
        convert.params_from_jax(tree, tc), tc, tb["input_values"],
        tb["lengths"], labels=tb["labels"])
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]),
                               rtol=0, atol=1e-4)
    assert out["logits"].shape == (4, 12, 384)


def test_forward_without_labels_starts_the_decoder():
    jc, tc = _cfgs("eed")
    tree, batch = _tree(jc), _batch(rows=2)
    ref = j_smx.speechmix_forward(_j(tree), jc,
                                  jnp.asarray(batch["input_values"]),
                                  jnp.asarray(batch["lengths"]))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(convert.params_from_jax(tree, tc), tc,
                                  tb["input_values"], tb["lengths"])
    assert "loss" not in out and out["logits"].shape == (2, 1, 384)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_grad_tree():
    """jax.grad of the eed loss on _tree / _batch, jitted with the weights
    and the batch as arguments and taken once for the file's cases."""
    jc, _ = _cfgs("eed")

    def loss_fn(p, b):
        return j_smx.speechmix_forward(
            p, jc, b["input_values"], b["lengths"],
            labels=b["labels"])["loss"]
    return jax.jit(jax.grad(loss_fn))(_j(_tree(jc)), _j(_batch()))


@pytest.mark.parametrize("min_rows", [1024, 1],
                         ids=["plain-chain", "kernel-functions"])
def test_gradient_tree_matches_jax_grad(min_rows, monkeypatch):
    """Every leaf of d loss / d params.  With the row gate at 1 (and the
    width gate at 1, for the tiny widths) the port's blocks run
    ffn_res_ln_trainable, dense_res_ln_trainable and attention_trainable
    (plain versions on the CPU)."""
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
    jc, tc = _cfgs("eed")
    tree, batch = _tree(jc), _batch()
    ref = _jax_grad_tree()

    params = convert.params_from_jax(tree, tc)
    leaves = t_trainer.tree_map(lambda p: p.requires_grad_(), params)
    tb = _t_batch(batch)
    loss = t_smx.speechmix_forward(leaves, tc, tb["input_values"],
                                   tb["lengths"], labels=tb["labels"])["loss"]
    flat = [leaf for _, leaf in t_trainer.tree_paths(leaves)]
    # masked_spec_embed is unused without SpecAugment: its gradient is 0
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grad_tree = t_trainer.tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(grads)), leaves)
    _assert_trees_close(grad_tree, ref, rel=1e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["eed", "example_mask", "fixed"])
def test_three_train_steps_match_jax(case):
    variant = "fixed" if case == "fixed" else "eed"
    jc, tc = _cfgs(variant)
    tree, batch = _tree(jc), _batch()
    if case == "example_mask":
        batch["example_mask"] = np.array([True, True, False, True])
    kw = dict(learning_rate=LR, warmup_steps=1, lr_schedule="linear",
              max_steps=10, max_grad_norm=1.0, grad_accum=2, dropout=False,
              optimizer="adamw", fixed_speech=False, fixed_nlp=True)
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

    for step in range(1, 4):
        j_state, j_metrics = j_step(j_state, j_batch, jnp.float32(1.0))
        t_state, t_metrics = t_step(t_state, tb)
        for name in ("loss", "grad_norm"):
            ref = float(j_metrics[name])
            assert abs(t_metrics[name].item() - ref) <= 1e-4 * abs(ref) + \
                1e-6, (step, name, t_metrics[name].item(), ref)
        _assert_trees_close(t_state.params, j_state.params, rel=1e-4,
                            atol=2e-6, noise_atol=step * LR)
        assert t_state.step == step == int(j_state.step)
    if case == "fixed":   # the frozen NLP model did not move
        before = convert.params_from_jax(tree, tc)["nlp"]
        for (path, a), (_, b) in zip(t_trainer.tree_paths(before),
                                     t_trainer.tree_paths(params["nlp"])):
            assert torch.equal(a, b), path


def test_first_update_has_rate_zero_and_loss_falls():
    """Counts start at 0, so with warmup_steps=1 step 1 changes nothing; the
    following steps on one batch lower the loss."""
    _, tc = _cfgs("eed")
    t_tc = t_trainer.TrainConfig(learning_rate=LR, warmup_steps=1,
                                 dropout=False, optimizer="adamw")
    state = t_trainer.create_train_state(torch.Generator().manual_seed(0),
                                         tc, t_tc, device="cpu")
    before = [p.clone() for _, p in t_trainer.tree_paths(state.params)]
    step = t_trainer.make_train_step(tc, t_tc, state.params, device="cpu")
    tb = _t_batch(_batch())
    losses = []
    for i in range(5):
        state, metrics = step(state, tb)
        losses.append(metrics["loss"].item())
        if i == 0:
            after = [p for _, p in t_trainer.tree_paths(state.params)]
            assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)
    assert losses[4] < losses[1]
    assert state.opt_state["count"] == 5


@pytest.mark.parametrize("kwargs,error", [
    (dict(dropout=True, sequence_parallel=2), None),
    (dict(dropout=False, optimizer="adafactor", zero1=True), None),
    (dict(dropout=False, freeze_epochs=2, model_parallel=2), None),
    (dict(dropout=False, optimizer="adamw", zero1=True), None),
    (dict(dropout=False, optimizer="adamw", model_parallel=2), None),
    (dict(dropout=False, optimizer="sgd"), ValueError),
])
def test_train_step_refuses_unported_settings(kwargs, error):
    """An unknown optimizer is refused.  Model and sequence parallelism and
    ZeRO-1 are ported (parallel.mesh); without a mesh they change nothing,
    as the JAX package's step without a mesh: two steps with them equal
    two steps without them bit for bit."""
    _, tc = _cfgs("eed")
    if error is not None:
        params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0),
                                      "cpu")
        with pytest.raises(error):
            t_trainer.make_train_step(tc, t_trainer.TrainConfig(**kwargs),
                                      params, device="cpu")
        return
    plain = {k: v for k, v in kwargs.items()
             if k not in ("sequence_parallel", "model_parallel", "zero1")}
    tb = _t_batch(_batch())
    runs = []
    for kw in (kwargs, plain):
        t_tc = t_trainer.TrainConfig(learning_rate=LR, warmup_steps=0, **kw)
        params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0),
                                      "cpu")
        state = t_trainer.TrainState(
            params, t_trainer.make_optimizer(t_tc).init(params), 0)
        step = t_trainer.make_train_step(tc, t_tc, params, device="cpu")
        losses = []
        for _ in range(2):
            state, metrics = step(state, tb, 0.5)
            losses.append(metrics["loss"].item())
        runs.append((losses, [p.clone() for _, p in
                              t_trainer.tree_paths(state.params)]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("variant", ["self", "gan", "adapter"])
def test_t5_variants_match_jax(variant):
    """The self, gan and adapter variants with tiny-t5-bytes (pad = start =
    0): the loss and its named terms within 1e-5 (relative, above 1) of the
    JAX package's; the gan case also holds the decoder mask of its Gram
    features: position 0 (the start token, equal to pad) valid, every other
    pad not."""
    jc, tc = (dataclasses.replace(
        c, decoder=m.SEQ2SEQ_PRESETS["tiny-t5-bytes"])
        for c, m in zip(_cfgs(variant), (jcfg, tcfg)))
    tree = _tree(jc)
    if variant == "gan":
        rng = np.random.RandomState(7)
        kernel = tree["discriminator"]["kernel"]
        tree["discriminator"] = dict(
            tree["discriminator"],
            kernel=(rng.randn(*kernel.shape) * 1e-3).astype(np.float32))
    batch = _batch()
    text = np.random.RandomState(3).randint(3, 384, (4, 10)).astype(np.int32)
    text[1, 7:] = text[2, 4:] = 0
    kw = {} if variant == "adapter" else {"text_input_ids": text}
    ref = jax.jit(lambda p, b, k: j_smx.speechmix_forward(
        p, jc, b["input_values"], b["lengths"], labels=b["labels"], **k))(
            _j(tree), _j(batch), _j(kw))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(
        convert.params_from_jax(tree, tc), tc, tb["input_values"],
        tb["lengths"], labels=tb["labels"],
        **{k: torch.from_numpy(v).long() for k, v in kw.items()})
    terms = {"self": ("ce_loss", "kld_loss", "mse_loss"),
             "gan": ("voice_enc_loss", "voice_dec_loss", "nlp_enc_loss",
                     "nlp_dec_loss"), "adapter": ()}[variant]
    for name in ("loss",) + terms:
        want = float(ref[name])
        assert abs(out[name].item() - want) <= 1e-5 * max(1.0, abs(want)), \
            name
    if variant == "gan":
        dec_ids = t_s2s.shift_tokens_right(tb["labels"], 0, 0)
        mask = t_smx.gan_decoder_mask(dec_ids, 0)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(
            j_smx.gan_decoder_mask(jnp.asarray(dec_ids.numpy()), 0)))
        assert mask[:, 0].all() and (dec_ids[:, 0] == 0).all()
        assert torch.equal(mask[:, 1:], dec_ids[:, 1:] != 0)
        assert not mask[1].all()


def test_dropout_generator_is_refused():
    """The dropout key is a host DropoutKey; a torch.Generator (or any other
    type) is refused."""
    _, tc = _cfgs("eed")
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0), "cpu")
    for wrong in (torch.Generator(), 1234):
        with pytest.raises(TypeError):
            t_smx.speechmix_forward(params, tc, torch.zeros(1, 4000),
                                    dropout_rng=wrong)
