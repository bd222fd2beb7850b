"""Gradual unfreezing of the speech encoder in the port against the JAX
package, float32 on the CPU: the tensor-granularity mask (the reference's
FreezingCallback, freezing.reference_unfreeze_scale) and the layer-granularity
mask (freezing.gradual_unfreeze_scale) leaf for leaf on a post-LN and a
pre-LN tree at several progress values, the registration ranks, and three
train steps with freeze_epochs=2 at progress 0, 0.5 and 1.0 against the JAX
step at the tolerances of test_torch_adafactor.py.

The port's layers are separate leaves, so where the JAX mask of a stacked
leaf is an (L, 1, ...) array the port has L per-layer numbers; the comparison
stacks them again (convert.tree_to_jax_layout).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.training import freezing as j_freezing
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.training import freezing as t_freezing
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_adafactor import _assert_params_close
from test_torch_train import LR, _batch, _cfgs, _flat, _j, _t_batch, _tree
from torch_threads import one_torch_thread  # noqa: F401

PROGRESS = (0.0, 0.1, 0.2, 0.25, 1 / 3, 0.4, 0.5, 0.6, 2 / 3, 0.75, 0.8,
            0.99, 1.0, 1.5)


def _trees(pre_ln):
    """The JAX tree and the port's of the tiny pair, post-LN (tiny-speech,
    4 layers) or pre-LN (the same widths with the -large presets'
    switches: LayerNorm in every extractor layer, conv biases)."""
    def build(mod):
        enc = mod.SPEECH_ENCODER_PRESETS["tiny-speech"]
        if pre_ln:
            enc = dataclasses.replace(enc, do_stable_layer_norm=True,
                                      feat_extract_norm="layer",
                                      conv_bias=True)
        return mod.SpeechMixConfig(
            encoder=enc, decoder=mod.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
            down_scale=2)
    jc, tc = build(jcfg), build(tcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    return tree, convert.params_from_jax(tree, tc)


def _mask_in_jax_layout(mask):
    layout = convert.tree_to_jax_layout(t_freezing.tree_map(torch.tensor,
                                                            mask))
    return {path: a.reshape(-1) for path, a in _flat(layout).items()}


def _jax_path(path):
    """A port path in the JAX tree: a transformer layer's index dropped."""
    parts = path.split("/")
    return "/".join(p for i, p in enumerate(parts)
                    if not (p.isdigit() and parts[i - 1] == "layers"
                            and "feature_extractor" not in parts))


def _assert_masks_equal(port_mask, jax_mask):
    got = _mask_in_jax_layout(port_mask)
    want = {path: np.asarray(a, np.float32).reshape(-1)
            for path, a in _flat(jax_mask).items()}
    assert got.keys() == want.keys()
    for path, ref in want.items():
        # a JAX mask of one number over a layer stack holds for each layer
        np.testing.assert_array_equal(
            got[path], np.broadcast_to(ref, got[path].shape), err_msg=path)


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-ln", "pre-ln"])
def test_encoder_tensor_ranks_match_jax(pre_ln):
    tree, params = _trees(pre_ln)
    j_ranks, j_total = j_freezing._encoder_tensor_ranks(tree["speech_encoder"])
    ranks, total = t_freezing._encoder_tensor_ranks(params["speech_encoder"])
    assert total == j_total
    n_layers = len(params["speech_encoder"]["layers"])
    for path, rank in j_ranks.items():
        rank = np.asarray(rank)
        if rank.ndim == 0:
            assert ranks[path] == rank, path
            continue
        name = path[len("layers/"):]
        got = [ranks[f"layers/{layer}/{name}"] for layer in range(n_layers)]
        np.testing.assert_array_equal(got, rank, err_msg=path)
    # every leaf of the encoder has a rank, each rank once
    assert sorted(ranks.values()) == list(range(total))
    order = sorted(ranks, key=ranks.get)
    assert order[0] == "masked_spec_embed"
    assert order.index("encoder_layer_norm/scale") == \
        order.index("pos_conv/kernel") + 1


@pytest.mark.parametrize("freeze_epochs", [2, 3])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-ln", "pre-ln"])
def test_tensor_granularity_mask_matches_jax(pre_ln, freeze_epochs):
    tree, params = _trees(pre_ln)
    seen = set()
    for progress in PROGRESS:
        epoch = progress * freeze_epochs
        want = j_freezing.reference_unfreeze_scale(
            tree, jnp.float32(progress) * freeze_epochs, freeze_epochs)
        mask = t_freezing.reference_unfreeze_scale(
            params, t_freezing.unfreeze_epoch(progress, freeze_epochs),
            freeze_epochs)
        _assert_masks_equal(mask, want)
        trainable, frozen = t_freezing.count_trainable(params, mask)
        assert len(trainable) + len(frozen) == len(
            t_freezing.tree_paths(params))
        seen.add(len(frozen))
        if 1 <= epoch < freeze_epochs:     # the top layer trains, the bottom
            assert frozen                  # extractor does not
            assert all(p.startswith("speech_encoder") for p in frozen)
            assert "speech_encoder/feature_extractor/layers/0/conv/kernel" \
                in frozen
    assert len(seen) >= freeze_epochs   # the boundary moved


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post-ln", "pre-ln"])
def test_layer_granularity_mask_matches_jax(pre_ln):
    tree, params = _trees(pre_ln)
    n_layers = len(params["speech_encoder"]["layers"])
    for progress in PROGRESS:
        want = j_freezing.gradual_unfreeze_scale(tree, jnp.float32(progress))
        mask = t_freezing.gradual_unfreeze_scale(params, progress)
        _assert_masks_equal(mask, want)
        released = [layer for layer in range(n_layers) if mask[
            "speech_encoder"]["layers"][layer]["ffn_in"]["kernel"] > 0]
        # top layers first
        assert released == list(range(n_layers - len(released), n_layers))


def test_count_trainable_matches_jax():
    tree, params = _trees(False)
    want_grad, want_frozen = j_freezing.count_trainable(
        tree, j_freezing.reference_unfreeze_scale(tree, 1.0, 2))
    got_grad, got_frozen = t_freezing.count_trainable(
        params, t_freezing.reference_unfreeze_scale(params, 1.0, 2))
    # a stacked JAX leaf counts as trainable when any of its layers is
    grad = {_jax_path(p) for p in got_grad}
    assert grad == set(want_grad)
    assert {_jax_path(p) for p in got_frozen} - grad == set(want_frozen)


@pytest.mark.parametrize("granularity", ["tensor", "layer"])
def test_unfreezing_steps_match_jax(granularity):
    """freeze_epochs=2, Adafactor, no dropout: a step at progress 0, 0.5 and
    1.0 each; the frozen leaves of each step unchanged bit for bit."""
    jc, tc = _cfgs("eed")
    tree, batch = _tree(jc), _batch()
    kw = dict(learning_rate=LR, warmup_steps=0, max_grad_norm=1.0,
              grad_accum=1, dropout=False, freeze_epochs=2,
              unfreeze_granularity=granularity)
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
    frozen_counts = []
    for step, progress in enumerate((0.0, 0.5, 1.0), start=1):
        if granularity == "tensor":
            mask = t_freezing.reference_unfreeze_scale(
                params, t_freezing.unfreeze_epoch(progress, 2), 2)
        else:
            mask = t_freezing.gradual_unfreeze_scale(params, progress)
        _, frozen = t_freezing.count_trainable(params, mask)
        frozen_counts.append(len(frozen))
        before = {path: p.clone() for path, p in
                  t_freezing.tree_paths(params) if path in frozen}
        j_state, j_metrics = j_step(j_state, j_batch, jnp.float32(progress))
        t_state, t_metrics = t_step(t_state, tb, progress)
        for name in ("loss", "grad_norm"):
            ref = float(j_metrics[name])
            assert abs(t_metrics[name].item() - ref) <= 1e-4 * abs(ref) + \
                1e-6, (step, name, t_metrics[name].item(), ref)
        _assert_params_close(t_state.params, j_state.params, step)
        after = dict(t_freezing.tree_paths(params))
        for path, p in before.items():
            assert torch.equal(after[path], p), (step, path)
    # tensor: epoch 0 trains everything; layer: progress 0 freezes the
    # whole encoder; both train everything at progress 1
    assert frozen_counts[1] > 0 and frozen_counts[2] == 0
    assert (frozen_counts[0] == 0) == (granularity == "tensor")
