"""The port's CTC head against the JAX package's, on the CPU in float32:
ctc_apply's logits, frame lengths and loss (optax.ctc_loss's value, also on
a row too short for its labels, where optax gives a large finite number and
PyTorch's ctc_loss inf; label_lengths given and derived), the loss gradient
over the whole tree against jax.grad, and ctc_greedy_decode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import ctc as j_ctc
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.models import ctc as t_ctc
from speechmix_tpu_torch.training.freezing import tree_paths
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 32


def _model(seed=0):
    jc = jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"]
    tc = tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"]
    tree = jax.tree_util.tree_map(
        np.asarray, j_ctc.init_ctc_model(jax.random.PRNGKey(seed), jc, VOCAB))
    rng = np.random.RandomState(seed)
    # a head wide enough that the frames' argmax moves
    tree["lm_head"]["kernel"] = (rng.randn(64, VOCAB) * 0.2).astype(
        np.float32)
    params = {"encoder": convert.speech_encoder_from_jax(tree["encoder"]),
              "lm_head": {k: torch.from_numpy(v.copy())
                          for k, v in tree["lm_head"].items()}}
    return jc, tc, tree, params


def _batch(infeasible):
    """Three utterances of 99, 74 and 49 frames, or with `infeasible` the
    last of 120 samples: 5 frames, where its labels need 7 (6 labels and
    the blank between the repeated 7s)."""
    rng = np.random.RandomState(1)
    wav = (rng.randn(3, 2000) * 0.1).astype(np.float32)
    lens = np.array([2000, 1500, 120 if infeasible else 1000], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    labels = np.array([[5, 6, 7, 5, 0, 0], [8, 9, 0, 0, 0, 0],
                       [7, 7, 3, 9, 11, 12]], np.int32)
    return wav, lens, labels


@pytest.mark.parametrize("given_lengths", [True, False])
def test_ctc_apply_matches_jax(given_lengths):
    jc, tc, tree, params = _model()
    wav, lens, labels = _batch(infeasible=True)
    label_lengths = np.array([4, 2, 6], np.int32) if given_lengths else None
    want = j_ctc.ctc_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(wav),
        jnp.asarray(lens), labels=jnp.asarray(labels),
        label_lengths=(None if label_lengths is None
                       else jnp.asarray(label_lengths)))
    got = t_ctc.ctc_apply(
        params, tc, torch.from_numpy(wav), torch.from_numpy(lens),
        labels=torch.from_numpy(labels),
        label_lengths=(None if label_lengths is None
                       else torch.from_numpy(label_lengths)))
    ref = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(got["frame_lengths"].numpy(),
                                  np.asarray(want["frame_lengths"]))
    np.testing.assert_array_equal(got["frame_mask"].numpy(),
                                  np.asarray(want["frame_mask"]))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert got["frame_lengths"][2] == 5 and got["loss"].item() > 1e4


def test_infeasible_row_gets_optax_value_not_inf():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 10, 5).astype(np.float32)
    logit_pad = np.zeros((2, 10), np.float32)
    logit_pad[1, 4:] = 1.0                      # 4 frames for 5 labels
    labels = np.array([[1, 2, 2, 3, 0], [1, 2, 3, 4, 1]], np.int32)
    label_pad = np.zeros((2, 5), np.float32)
    label_pad[0, 4] = 1.0
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits),
                                     jnp.asarray(logit_pad),
                                     jnp.asarray(labels),
                                     jnp.asarray(label_pad)))
    got = t_ctc.ctc_loss(torch.from_numpy(logits),
                         torch.from_numpy(logit_pad),
                         torch.from_numpy(labels),
                         torch.from_numpy(label_pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(got).all() and got[1] > 5e4
    # torch's own loss: the same on the feasible row, inf on the other
    lp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    torch_loss = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels).long(), torch.tensor([10, 4]),
        torch.tensor([4, 5]), reduction="none")
    np.testing.assert_allclose(torch_loss[0].item(), got[0], rtol=1e-5)
    assert torch.isinf(torch_loss[1])


def test_ctc_loss_gradient_matches_jax_grad():
    """On feasible rows: in float32 a loss near 1e5 (an infeasible row)
    holds its log-probabilities only to ~1e-2, and its gradient no better,
    in either package."""
    jc, tc, tree, params = _model(seed=3)
    wav, lens, labels = _batch(infeasible=False)
    label_lengths = np.array([4, 2, 6], np.int32)

    def j_loss(p):
        return j_ctc.ctc_apply(p, jc, jnp.asarray(wav), jnp.asarray(lens),
                               labels=jnp.asarray(labels),
                               label_lengths=jnp.asarray(
                                   label_lengths))["loss"]
    want = jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, tree))
    want = {"encoder": convert.speech_encoder_from_jax(jax.tree_util.tree_map(
                np.asarray, want["encoder"])),
            "lm_head": {k: torch.from_numpy(np.asarray(v))
                        for k, v in want["lm_head"].items()}}
    leaves = {path: p.requires_grad_() for path, p in tree_paths(params)}
    loss = t_ctc.ctc_apply(params, tc, torch.from_numpy(wav),
                           torch.from_numpy(lens),
                           labels=torch.from_numpy(labels),
                           label_lengths=torch.from_numpy(label_lengths))["loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    want = dict(tree_paths(want))
    assert sorted(want) == sorted(leaves)
    # each leaf within 1e-4 of its largest element, plus 1e-7 for the
    # k_proj biases, whose exact gradient is 0 (tests/test_torch_train.py's
    # rule)
    for path, g in zip(leaves, grads):
        ref = want[path].numpy()
        g = np.zeros_like(ref) if g is None else g.numpy()
        limit = 1e-4 * np.abs(ref).max() + 1e-7
        assert np.abs(g - ref).max() <= limit, path


def test_ctc_greedy_decode_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 12, 6).astype(np.float32)
    logits[0, :, 2] += 3.0                      # repeats to collapse
    logits[1, 3:7, 0] += 5.0                    # blanks to drop
    mask = np.ones((3, 12), bool)
    mask[2, 5:] = False
    want = j_ctc.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(mask))
    got = t_ctc.ctc_greedy_decode(torch.from_numpy(logits),
                                  torch.from_numpy(mask))
    assert got == want
    assert got[0] == [2] and len(got[2]) <= 5
