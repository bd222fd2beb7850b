"""The port's Adafactor against optax's, float32 on the CPU.

The update must be optax's chain(clip_by_global_norm, adafactor(schedule,
multiply_by_parameter_scale=False, min_dim_size_to_factor=0)), the JAX
package's default optimizer, applied to ``convert.tree_to_jax_layout`` of the
port's parameters: the factored axes come from the JAX leaf's shape, a layer
list is one stacked leaf (a stacked vector is factored across its layers, a
stacked matrix is clipped as a whole), a conv kernel is (K, C_in, C_out), and
a leaf whose gradient is 0 still moves its statistics.

Tolerances.  The standalone update: parameters and statistics within 1e-6 of
the leaf's largest magnitude.  The train steps: those of
test_torch_train.py (loss 1e-4 relative, parameters 1e-4 relative + 2e-6),
and statistics within 1e-3 relative (they are squares of gradients that
agree to 1e-4).  Attention key biases have a gradient that is rounding noise
(zero in exact arithmetic); Adafactor scales it to an update of block RMS
up to the learning rate, in a direction of its own on each side, so these
leaves are held to the learning rate per step in RMS on each side (their
difference's RMS to twice that), their statistics to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_train import LR, _batch, _cfgs, _flat, _j, _t_batch, _tree
from torch_threads import one_torch_thread  # noqa: F401

L = 3


def _port_tree(rng):
    """A port-shaped tree whose JAX layout holds each kind of leaf: stacked
    (L, a, b) matrices (one square, one with a > b), stacked (L, n) vectors,
    a conv kernel, a (H^2, 1) discriminator and a plain matrix."""
    t = lambda *shape: torch.from_numpy(
        (rng.randn(*shape) * 0.3).astype(np.float32))
    return {
        "speech_encoder": {"layers": [
            {"ffn_in": {"kernel": t(16, 40), "bias": t(40)},
             "square": {"kernel": t(24, 24)},
             "tall": {"kernel": t(40, 12)},
             "final_layer_norm": {"scale": t(16), "bias": t(16)}}
            for _ in range(L)]},
        "length_adapter": [{"kernel": t(16, 12, 2), "bias": t(16)}],
        "pos_conv": {"kernel": t(16, 4, 6), "bias": t(16)},
        "discriminator": {"kernel": t(64, 1), "bias": t(1)},
        "released": {"kernel": t(20, 30)},
    }


def _random_like(tree, rng, zero=None):
    """Random gradients shaped like `tree`, 0 under the path prefix
    `zero`."""
    def draw(path, p):
        if zero and path.startswith(zero):
            return torch.zeros_like(p)
        return torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    return t_trainer.tree_map_with_path(draw, tree)


def _is_noise(path):
    return "k_proj" in path and "bias" in path


def _assert_params_close(port_params, jax_params, steps):
    got = _flat(convert.tree_to_jax_layout(port_params))
    want = _flat(jax_params)
    assert got.keys() == want.keys()
    for path, ref in want.items():
        diff = got[path] - ref
        if _is_noise(path):
            rms = np.sqrt(np.mean(diff.astype(np.float64) ** 2))
            assert rms <= 2 * LR * steps, f"{path}: rms {rms}"
        else:
            limit = 1e-4 * np.abs(ref).max() + 2e-6
            assert np.abs(diff).max() <= limit, f"{path}: > {limit}"


def _assert_close(got, want, rel, atol=0.0, what=""):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for path, ref in want.items():
        assert got[path].shape == ref.shape, (what, path)
        limit = rel * np.abs(ref).max() + atol
        err = np.abs(got[path] - ref).max()
        assert err <= limit, f"{what} {path}: {err} > {limit}"


@pytest.mark.parametrize("max_grad_norm", [1e3, 1.0],
                         ids=["unclipped", "clipped"])
def test_adafactor_matches_optax(max_grad_norm):
    """Five updates; the leaf "released" has gradient 0 in the first two."""
    rng = np.random.RandomState(0)
    params = _port_tree(rng)
    kw = dict(learning_rate=0.5, warmup_steps=2, max_steps=10,
              max_grad_norm=max_grad_norm)
    opt = t_trainer.Adafactor(t_trainer.TrainConfig(**kw))
    j_opt = j_trainer.make_optimizer(j_trainer.TrainConfig(**kw))
    j_params = _j(convert.tree_to_jax_layout(params))
    state, j_state = opt.init(params), j_opt.init(j_params)
    # the statistics' shapes are optax's, leaf for leaf
    _assert_close(convert.adafactor_state_to_jax(state)["v_row"],
                  j_state[1][0].v_row, 0.0, what="init")
    for step in range(5):
        grads = _random_like(params, rng,
                             zero="released" if step < 2 else None)
        t_trainer.tree_map(lambda g: g.mul_(step + 1.0), grads)
        state = opt.update_(params, grads, state,
                            t_trainer.global_norm(grads))
        updates, j_state = j_opt.update(
            _j(convert.tree_to_jax_layout(grads)), j_state, j_params)
        j_params = jax.tree_util.tree_map(jnp.add, j_params, updates)
        _assert_close(convert.tree_to_jax_layout(params), j_params, 1e-6,
                      what=f"step {step} params")
        jstats = j_state[1][0]
        got = convert.adafactor_state_to_jax(state)
        assert got["count"] == int(jstats.count) == step + 1
        for name in ("v_row", "v_col", "v"):
            _assert_close(got[name], getattr(jstats, name), 1e-6,
                          what=f"step {step} {name}")
    # a stacked vector is factored across its layers; a conv kernel in
    # the JAX order (K, C_in, C_out) = (6, 4, 16): rows over C_out, columns
    # over K
    v_row = got["v_row"]["speech_encoder"]["layers"]["final_layer_norm"]
    assert v_row["scale"].shape == (L,)
    assert got["v_row"]["pos_conv"]["kernel"].shape == (6, 4)
    assert got["v_col"]["pos_conv"]["kernel"].shape == (4, 16)


def test_frozen_leaf_moves_statistics_not_weights():
    """A zero gradient leaves the parameter bit-unchanged while its second
    moment decays, as optax's does."""
    rng = np.random.RandomState(1)
    params = _port_tree(rng)
    before = params["released"]["kernel"].clone()
    opt = t_trainer.Adafactor(t_trainer.TrainConfig(learning_rate=0.5,
                                                    warmup_steps=0))
    state = opt.init(params)
    grads = _random_like(params, rng)
    state = opt.update_(params, grads, state, t_trainer.global_norm(grads))
    v1 = state["v_row"]["released"]["kernel"].clone()
    assert not torch.equal(params["released"]["kernel"], before)
    before = params["released"]["kernel"].clone()
    grads["released"]["kernel"].zero_()
    state = opt.update_(params, grads, state, t_trainer.global_norm(grads))
    assert torch.equal(params["released"]["kernel"], before)
    assert (state["v_row"]["released"]["kernel"] < v1).all()


@pytest.mark.parametrize("case", ["eed", "fixed"])
def test_three_adafactor_train_steps_match_jax(case):
    """make_train_step(cfg, TrainConfig(dropout=False)) with the default
    optimizer, gradient accumulation 2, against the JAX step; parameters and
    Adafactor statistics after each step (fixed: the frozen NLP model's
    statistics see zero gradients on both sides)."""
    jc, tc = _cfgs(case)
    tree, batch = _tree(jc), _batch()
    kw = dict(learning_rate=LR, warmup_steps=1, lr_schedule="linear",
              max_steps=10, max_grad_norm=1.0, grad_accum=2, dropout=False)
    j_tc = j_trainer.TrainConfig(use_flash=False, **kw)
    t_tc = t_trainer.TrainConfig(**kw)
    assert t_tc.optimizer == j_tc.optimizer == "adafactor"

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
        j_state, j_metrics = j_step(j_state, j_batch, jnp.float32(0.0))
        t_state, t_metrics = t_step(t_state, tb)
        for name in ("loss", "grad_norm"):
            ref = float(j_metrics[name])
            assert abs(t_metrics[name].item() - ref) <= 1e-4 * abs(ref) + \
                1e-6, (step, name, t_metrics[name].item(), ref)
        _assert_params_close(t_state.params, j_state.params, step)
        got = convert.adafactor_state_to_jax(t_state.opt_state)
        jstats = j_state.opt_state[1][0]
        assert got["count"] == int(jstats.count) == step
        for name in ("v_row", "v_col", "v"):
            want = _flat(getattr(jstats, name))
            have = _flat(got[name])
            assert have.keys() == want.keys()
            for path, ref in want.items():
                limit = (1e-10 if _is_noise(path)
                         else 1e-3 * np.abs(ref).max())
                assert np.abs(have[path] - ref).max() <= limit, (step, name,
                                                                 path)
