"""The port's dropout-on training slice, float32 on the CPU: SpecAugment's
span sampler against the JAX package's for the same draws, LayerDrop, the
rate-0 dropout=True step against the JAX step, and the flagship-rate step's
determinism.

Tiny configuration of tests/test_torch_train.py (tiny-speech cut to 2
layers + tiny-bart-bytes).  Tolerances: the rate-0 step as that file's
three-step test (loss and grad_norm 1e-4 relative, parameters 1e-4 of
their largest magnitude plus 2e-6); paths that draw the same masks agree to
1e-5 of the largest magnitude (order of summation only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speech_encoder as j_se
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_train import (LR, _assert_trees_close, _batch, _j, _t_batch,
                              _tree)
from torch_threads import one_torch_thread  # noqa: F401

ZERO_RATES = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
# the flagship's training recipe on the tiny widths: wav2vec2-base's and
# bart-base's rates, SpecAugment and LayerDrop on
FLAGSHIP_SPEECH = dict(apply_spec_augment=True, layerdrop=0.1)


def _cfgs(speech_kw=(), text_kw=(), num_layers=2):
    def build(mod):
        enc = dataclasses.replace(mod.SPEECH_ENCODER_PRESETS["tiny-speech"],
                                  num_layers=num_layers, **dict(speech_kw))
        dec = dataclasses.replace(mod.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
                                  **dict(text_kw))
        return mod.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2,
                                   variant="eed")
    return build(jcfg), build(tcfg)


# ------------------------------------------------------------ SpecAugment
@pytest.mark.parametrize("size,lengths,prob,mask_len,min_masks", [
    (399, (399, 301, 120, 9), 0.05, 10, 2),    # time masks, wav2vec2 rates
    (399, (399, 399, 250, 40), 0.3, 10, 0),    # many spans, overlaps
    (64, (64, 64, 64, 64), 0.2, 10, 0),        # feature masks (full rows)
    (50, (50, 7, 0, 12), 0.65, 3, 1),          # rows with little or no room
])
def test_compute_mask_spans_matches_jax(size, lengths, prob, mask_len,
                                        min_masks):
    """The JAX sampler's two draws handed to the port's pure function."""
    batch = len(lengths)
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        ref = j_se.compute_mask_spans(rng, batch, size,
                                      jnp.asarray(lengths), prob, mask_len,
                                      min_masks)
        r_eps, r_starts = jax.random.split(rng)
        eps = torch.tensor(float(jax.random.uniform(r_eps, ())))
        u = torch.from_numpy(np.array(
            jax.random.uniform(r_starts, (batch, size))))
        got = t_se.compute_mask_spans(eps, u, torch.tensor(lengths), prob,
                                      mask_len, min_masks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_spec_augment_replaces_time_spans():
    """Only SpecAugment stochastic (rates 0, LayerDrop 0): the masked frames
    of the projection get masked_spec_embed, and the time mask is the one
    the site key's draws give."""
    _, tc = _cfgs(dict(ZERO_RATES, feat_proj_dropout=0.0,
                       apply_spec_augment=True, mask_time_prob=0.3))
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0),
                                  "cpu")["speech_encoder"]
    wav = torch.from_numpy(_batch()["input_values"])
    key = DropoutKey.from_seed(3)
    seen = {}
    original = t_se.layers.conv1d_same_grouped

    def spy(p, h, *a):
        seen["h"] = h
        return original(p, h, *a)
    t_se.layers.conv1d_same_grouped = spy
    try:
        t_se.speech_encoder_apply(params, tc.encoder, wav, dropout_rng=key)
    finally:
        t_se.layers.conv1d_same_grouped = original
    k_spec = key.split(4)[3]
    b, t = seen["h"].shape[:2]
    tmask = t_se.compute_time_mask(
        *t_se.mask_span_draws(k_spec.split(2)[0], b, t, "cpu"),
        torch.full((b,), t), 0.3, tc.encoder.mask_time_length,
        tc.encoder.mask_time_min_masks)
    assert tmask.any() and not tmask.all()
    embed = params["masked_spec_embed"].expand(int(tmask.sum()), -1)
    assert torch.equal(seen["h"][tmask], embed)
    assert not (seen["h"][~tmask] == params["masked_spec_embed"]).all(-1).any()


# --------------------------------------------------------------- LayerDrop
def test_layerdrop_skips_its_layers():
    """With every other rate 0, a LayerDrop forward equals the deterministic
    forward over the layers it kept; the decisions are the key's draws."""
    _, tc = _cfgs(dict(ZERO_RATES, feat_proj_dropout=0.0, layerdrop=0.5),
                  num_layers=4)
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0),
                                  "cpu")["speech_encoder"]
    wav = torch.from_numpy(_batch(rows=2)["input_values"])
    for seed in range(6):
        key = DropoutKey.from_seed(seed)
        out = t_se.speech_encoder_apply(params, tc.encoder, wav,
                                        dropout_rng=key)
        k_drop = key.split(4)[2].split(2)[1]
        skips = t_se.layerdrop_skips(k_drop, 4, 0.5)
        assert out["layers_skipped"] == [i for i, s in enumerate(skips) if s]
        kept = dict(params, layers=[p for p, s in zip(params["layers"], skips)
                                    if not s])
        ref = t_se.speech_encoder_apply(kept, tc.encoder, wav)
        assert torch.equal(out["last_hidden_state"],
                           ref["last_hidden_state"])
    assert t_se.layerdrop_skips(DropoutKey.from_seed(0), 12, 0.0) == \
        [False] * 12


# -------------------------------------------------- rate 0 against the JAX step
def test_rate_zero_dropout_step_matches_jax():
    """dropout=True with every rate 0, SpecAugment off and LayerDrop 0: three
    AdamW steps against the JAX package's step with dropout=True."""
    zero_speech = dict(ZERO_RATES, feat_proj_dropout=0.0)
    jc, tc = _cfgs(zero_speech, ZERO_RATES)
    tree, batch = _tree(jc), _batch()
    kw = dict(learning_rate=LR, warmup_steps=1, lr_schedule="linear",
              max_steps=10, max_grad_norm=1.0, grad_accum=2, dropout=True,
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


# ------------------------------------------------------ flagship rates
def _flagship_step(min_rows, monkeypatch, steps=3, seed=0):
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)   # the tiny widths
    _, tc = _cfgs(FLAGSHIP_SPEECH)
    t_tc = t_trainer.TrainConfig(learning_rate=LR, warmup_steps=0,
                                 grad_accum=2, optimizer="adamw", seed=seed)
    assert t_tc.dropout
    state = t_trainer.create_train_state(torch.Generator().manual_seed(0),
                                         tc, t_tc, device="cpu")
    step_fn = t_trainer.make_train_step(tc, t_tc, state.params, device="cpu")
    tb = _t_batch(_batch())
    out = []
    for _ in range(steps):
        state, metrics = step_fn(state, tb)
        out.append(metrics)
    return state, out


def test_flagship_rate_step_is_deterministic(monkeypatch):
    """The same (seed, step) gives the same step bit for bit; steps and
    seeds draw other masks; the loss is finite; the reported LayerDrop
    decisions are the key chain's."""
    a_state, a = _flagship_step(1, monkeypatch)
    b_state, b = _flagship_step(1, monkeypatch)
    for ma, mb in zip(a, b):
        assert ma["loss"].item() == mb["loss"].item()
        assert ma["grad_norm"].item() == mb["grad_norm"].item()
        assert ma["layers_skipped"] == mb["layers_skipped"]
    for (_, pa), (_, pb) in zip(t_trainer.tree_paths(a_state.params),
                                t_trainer.tree_paths(b_state.params)):
        assert torch.equal(pa, pb)
    losses = [m["loss"].item() for m in a]
    assert all(np.isfinite(losses))
    # the parameters move between steps, so the step keys' masks are
    # compared through one forward at fixed parameters
    _, tc = _cfgs(FLAGSHIP_SPEECH)
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0),
                                  "cpu")
    tb = _t_batch(_batch())
    t_tc = t_trainer.TrainConfig(grad_accum=2, optimizer="adamw")
    loss = lambda key: t_smx.speechmix_forward(
        params, tc, tb["input_values"][:2], tb["lengths"][:2],
        labels=tb["labels"][:2], dropout_rng=key)["loss"].item()
    keys = [t_trainer.dropout_keys(t_tc, s)[0] for s in range(3)]
    values = [loss(k) for k in keys]
    assert len(set(values)) == 3, values
    assert loss(keys[0]) == values[0]
    other = t_trainer.dropout_keys(
        t_trainer.TrainConfig(grad_accum=2, optimizer="adamw", seed=1), 0)[0]
    assert loss(other) != values[0]
    # the LayerDrop decisions the step reported, replayed from the chain
    for step, metrics in enumerate(a):
        for micro, key in enumerate(t_trainer.dropout_keys(
                t_trainer.TrainConfig(grad_accum=2, optimizer="adamw"),
                step)):
            k_drop = key.split(2)[0].split(4)[2].split(2)[1]
            skips = t_se.layerdrop_skips(k_drop, 2, 0.1)
            assert metrics["layers_skipped"][micro] == \
                [i for i, s in enumerate(skips) if s]


def test_masks_do_not_depend_on_the_row_gate(monkeypatch):
    """The kernels' differentiable functions (row gate 1) and the plain
    chain (gate 1024) draw the same masks: one dropout forward and its
    gradient tree agree."""
    _, tc = _cfgs(FLAGSHIP_SPEECH)
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(1),
                                  "cpu")
    tb = _t_batch(_batch())
    key = DropoutKey.from_seed(7)

    def run(min_rows):
        monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
        monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
        leaves = t_trainer.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
        out = t_smx.speechmix_forward(leaves, tc, tb["input_values"],
                                      tb["lengths"], labels=tb["labels"],
                                      dropout_rng=key)
        paths = t_trainer.tree_paths(leaves)
        grads = torch.autograd.grad(out["loss"], [leaf for _, leaf in paths],
                                    allow_unused=True)
        return out["loss"].item(), dict(zip([p for p, _ in paths], grads))

    loss_k, grads_k = run(1)
    loss_p, grads_p = run(1024)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for path, gp in grads_p.items():
        gk = grads_k[path]
        if gp is None:
            assert gk is None, path
            continue
        limit = 1e-5 * gp.abs().max().item() + 1e-7
        assert (gk - gp).abs().max().item() <= limit, path
    # SpecAugment hands masked_spec_embed a gradient
    assert grads_p["speech_encoder/masked_spec_embed"].abs().max() > 0
