"""SpeechMix with a T5 / ByT5 decoder family through the port's training
entry points, against the JAX package in float32 on the CPU:
speechmix_forward (eed, ed), one Adafactor train step with its statistics,
the freezing masks, the parameter and train-state bridges in both
directions; and, port only, the AdamW step with dropout and the Trainer's
fit / evaluate / predict with T5's byte ids (pad 0, eos 1, start 0).
(generate: test_torch_t5_generate.py.)

Configurations as in test_torch_t5 (tiny-speech cut to 2 layers, down_scale
2, with tiny-t5-bytes or the ByT5-like one), weights the JAX initialisation
redrawn from numpy.  Tolerances: loss and logits within 1e-5 of the largest
reference magnitude; parameters after a step within 1e-4 of the leaf's
largest magnitude plus 2e-6 (Adafactor divides by its own statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.training import freezing as j_freezing
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.data import tokenizer as t_tok
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.training import freezing as t_freezing
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_t5 import REL, smx_cfgs, smx_tree
from test_torch_train import _flat, _j, _t_batch
from test_torch_unfreeze import _assert_masks_equal
from torch_threads import one_torch_thread  # noqa: F401

T5_IDS = dict(pad_token_id=0, eos_token_id=1, bos_token_id=0)


def _batch(rows=3, label_len=9, seed=0):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(rows, 8000) * 0.1).astype(np.float32)
    lens = np.array([8000, 6100, 7000][:rows], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    labels = rng.randint(2, 384, size=(rows, label_len)).astype(np.int32)
    labels[1, 6:] = -100
    return {"input_values": wav, "lengths": lens, "labels": labels}


@pytest.mark.parametrize("name,variant", [("t5", "eed"), ("byt5", "eed"),
                                          ("t5", "ed")])
def test_speechmix_forward_matches_jax(name, variant):
    """Loss and logits; `ed` decodes from the projected speech states with
    no text-encoder pass."""
    jc, tc = smx_cfgs(name, variant)
    tree, batch = smx_tree(jc), _batch()
    ref = jax.jit(lambda p, b: j_smx.speechmix_forward(
        p, jc, b["input_values"], b["lengths"], labels=b["labels"]))(
            _j(tree), _j(batch))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(convert.params_from_jax(tree, tc), tc,
                                  tb["input_values"], tb["lengths"],
                                  labels=tb["labels"])
    ref_logits = np.asarray(ref["logits"])
    err = np.abs(out["logits"].detach().numpy() - ref_logits).max()
    assert err <= REL * np.abs(ref_logits).max()
    assert abs(out["loss"].item() - float(ref["loss"])) <= REL * float(
        ref["loss"])


# ---------------------------------------------------------------- training

def _step_setup(name, **kw):
    jc, tc = smx_cfgs(name)
    tree = smx_tree(jc)
    params = convert.params_from_jax(tree, tc)
    t_tc = t_trainer.TrainConfig(dropout=False, **kw)
    state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_tc).init(params), 0)
    return jc, tc, tree, t_tc, state


def test_adafactor_step_matches_jax():
    """One step of the default recipe (Adafactor, clipping, warmup), T5's
    leaves factored by the JAX layout's shapes (rel_bias (buckets, H) and
    the stacked RMS scales (L, H) into two vectors, the stacks' final norms
    (H,) not): parameters and statistics against the JAX step."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, lr_schedule="linear",
              max_steps=10, max_grad_norm=1.0)
    jc, tc, tree, t_tc, state = _step_setup("t5", **kw)
    j_tc = j_trainer.TrainConfig(use_flash=False, dropout=False, **kw)
    j_params = _j(tree)
    j_state = j_trainer.TrainState(
        j_params, j_trainer.make_optimizer(j_tc).init(j_params),
        jnp.zeros((), jnp.int32))
    batch = _batch()
    j_state, j_metrics = j_trainer.make_train_step(jc, j_tc, j_params)(
        j_state, _j(batch), jnp.float32(0.0))
    state, metrics = t_trainer.make_train_step(tc, t_tc, state.params,
                                               device="cpu")(
        state, _t_batch(batch))
    for key in ("loss", "grad_norm"):
        ref = float(j_metrics[key])
        assert abs(metrics[key].item() - ref) <= 1e-4 * abs(ref), key
    got = _flat(convert.tree_to_jax_layout(state.params))
    want = _flat(j_state.params)
    assert got.keys() == want.keys()
    for path, ref in want.items():
        limit = 1e-4 * np.abs(ref).max() + 2e-6
        assert np.abs(got[path] - ref).max() <= limit, path
    stats = convert.adafactor_state_to_jax(state.opt_state)
    jstats = j_state.opt_state[1][0]
    for key in ("v_row", "v_col", "v"):
        have, ref_stats = _flat(stats[key]), _flat(getattr(jstats, key))
        assert have.keys() == ref_stats.keys()
        for path, ref in ref_stats.items():
            assert have[path].shape == ref.shape, (key, path)
            # the speech encoder's attention key biases: a gradient that is
            # 0 in exact arithmetic, statistics of its rounding noise
            limit = (1e-10 if "k_proj" in path and "bias" in path
                     else 1e-3 * np.abs(ref).max())
            assert np.abs(have[path] - ref).max() <= limit, (key, path)
    # the (buckets, H) position table is factored: two statistics vectors
    rel = [stats[k]["nlp"]["encoder"]["rel_bias"]["embedding"].shape
           for k in ("v_row", "v_col", "v")]
    assert sorted(rel[:2]) == sorted(
        [(jc.decoder.num_heads,),
         (jc.decoder.relative_attention_num_buckets,)]) and rel[2] == (1,)


@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_adamw_step_with_dropout_is_deterministic(name):
    """AdamW with dropout at the presets' rates: two steps from the same
    state and key give the same bits, a finite loss, and a different loss
    from the deterministic step."""
    results = []
    for dropout in (True, True, False):
        _, tc, _, t_tc, state = _step_setup(name, optimizer="adamw")
        t_tc = t_trainer.TrainConfig(optimizer="adamw", dropout=dropout)
        step = t_trainer.make_train_step(tc, t_tc, state.params,
                                         device="cpu")
        state, metrics = step(state, _t_batch(_batch()))
        results.append((metrics["loss"].item(),
                        convert.tree_to_jax_layout(state.params)))
    (l1, p1), (l2, p2), (l3, _) = results
    assert np.isfinite(l1) and l1 == l2 and l1 != l3
    for path, a in _flat(p1).items():
        np.testing.assert_array_equal(a, _flat(p2)[path], err_msg=path)


@pytest.mark.parametrize("name", ["t5", "byt5"])
def test_params_round_trip(name):
    """params_from_jax then tree_to_jax_layout gives every JAX leaf back,
    rel_bias, the stacks' final_layer_norm, fc_gate and lm_head included;
    no bias, position table or final_logits_bias appears.  In a bf16 tree
    the (buckets, H) table is bf16, as in a bf16 JAX tree; the position
    bias is added in f32."""
    jc, tc = smx_cfgs(name)
    tree = smx_tree(jc)
    port = convert.params_from_jax(tree, tc)
    back = _flat(convert.tree_to_jax_layout(port))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for path, ref in want.items():
        np.testing.assert_array_equal(back[path], ref, err_msg=path)
    nlp = [p for p in want if p.startswith("['nlp']")]
    assert any("rel_bias" in p for p in nlp)
    assert not any(k in p for p in nlp for k in (
        "'bias'", "embed_positions", "layernorm_embedding",
        "final_logits_bias"))
    assert ("fc_gate" in str(nlp)) == (name == "byt5")
    assert ("lm_head" in str(nlp)) == (name == "byt5")
    bf = convert.params_from_jax(tree, tc, dtype=torch.bfloat16)
    assert bf["nlp"]["encoder"]["rel_bias"]["embedding"].dtype == \
        torch.bfloat16
    assert bf["nlp"]["encoder"]["final_layer_norm"]["scale"].dtype == \
        torch.float32


@pytest.mark.parametrize("variant,fixed_parameters", [
    ("fixed", False), ("fixed", True), ("adapter", False), ("self", False),
    ("ed", False)])
def test_freezing_masks_match_jax(variant, fixed_parameters):
    """The variants' static masks and, at progress 0.5, gradual unfreezing
    on a ByT5 tree (rel_bias, the stacks' final norms, fc_gate, lm_head):
    the JAX package's masks leaf for leaf, the substring policy of
    fixed_parameters reading T5's names."""
    import dataclasses
    jc, tc = (dataclasses.replace(c, fixed_parameters=fixed_parameters)
              for c in smx_cfgs("byt5", variant))
    tree = smx_tree(jc)
    params = convert.params_from_jax(tree, tc)
    for flags in ((False, True), (True, False)):
        _assert_masks_equal(
            t_freezing.variant_trainable_mask(params, tc, *flags),
            j_freezing.variant_trainable_mask(tree, jc, *flags))
    _assert_masks_equal(t_freezing.reference_unfreeze_scale(params, 1, 2),
                        j_freezing.reference_unfreeze_scale(tree, 1, 2))


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_train_state_round_trip(optimizer):
    """A T5 TrainState after a step, to the JAX checkpoint tree and back
    into a fresh state: every parameter, statistic, count and the step."""
    _, tc, _, t_tc, state = _step_setup("t5", optimizer=optimizer)
    state, _ = t_trainer.make_train_step(tc, t_tc, state.params,
                                         device="cpu")(
        state, _t_batch(_batch()))
    saved = convert.train_state_to_jax(state)
    _, _, _, _, fresh = _step_setup("t5", optimizer=optimizer)
    restored = convert.train_state_from_jax(saved, fresh)
    assert restored.step == state.step == 1
    again = convert.train_state_to_jax(restored)
    flat_a = dict(convert.flatten_with_paths(saved))
    flat_b = dict(convert.flatten_with_paths(again))
    assert flat_a.keys() == flat_b.keys()
    assert any("rel_bias" in p for p in flat_a)
    for path, a in flat_a.items():
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(a), err_msg=path)


def test_trainer_fit_evaluate_predict(tmp_path):
    """The port's Trainer on the T5 pair with T5's byte ids: two steps of
    fit with an eval and a checkpoint at step 2, evaluate and greedy
    predict (texts decoded up to EOS 1)."""
    _, tc = smx_cfgs("t5")
    tok = t_tok.ByteTokenizer(**T5_IDS)
    t_tc = t_trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                 dropout=False, output_dir=str(tmp_path),
                                 eval_steps=2, max_steps=2, logging_steps=1,
                                 prefetch_depth=0)
    trainer = t_trainer.Trainer(tc, t_tc, tokenizer=tok, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = _t_batch(_batch(rows=2))
    batch["labels"] = torch.where(batch["labels"] < 0, -100,
                                  batch["labels"] % 250 + 3)
    batch["labels"][:, -1] = T5_IDS["eos_token_id"]
    state = trainer.fit(state, lambda: iter([batch, batch]),
                        lambda: iter([batch]))
    assert state.step == 2 and trainer.ckpt.latest_step() == 2
    eval_fn = t_trainer.make_eval_step(tc, t_tc, device="cpu")
    metrics = trainer.evaluate(state.params, eval_fn, lambda: iter([batch]))
    assert np.isfinite(metrics["eval_loss"]) and "cer" in metrics
    preds = trainer.predict(state.params, lambda: iter([batch]),
                            max_length=6)
    assert preds["n_examples"] == 2 and np.isfinite(preds["predict_cer"])
