"""The port's checkpoints against the JAX package's, on the CPU.

The port writes the JAX package's files: ``step_<N>.npz`` with the same
``__paths__`` key strings, taken here from the JAX state of the same
configuration and optimizer, and the same ``.meta.json``.  A JAX-written
checkpoint restores into the port and a port-written one loads through the
JAX package's ``CheckpointManager.restore``, parameters, optimizer state,
counts and step equal to 0 ULP.  ``_prune`` keeps the best step as the JAX
manager does.

Resume.  A JAX ``Trainer.fit`` and the port's resume from the same
JAX-written step-1 checkpoint (Adafactor, statistics from a seed), take
steps 2 and 3 on the same batches, evaluate at step 2 and stop at
max_steps 3, then load the best step: the logged records are the same
(losses and eval metrics within 1e-4 relative, the argmax CER / WER
equal), the kept checkpoints are the same files, and the step-2
checkpoints (one step from the JAX-written one) agree within
test_torch_adafactor.py's limits: parameters 1e-4 relative + 2e-6 (the
attention key biases, whose gradient is rounding noise, within the
learning rate per step in RMS), statistics 1e-3 relative.
"""

import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.data import collator as j_coll
from speechmix_tpu.data import tokenizer as j_tok
from speechmix_tpu.parallel import mesh as mesh_lib
from speechmix_tpu.training import checkpoint as j_ckpt
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu.utils.pytree import tree_paths as j_tree_paths
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.training import checkpoint as t_ckpt
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_adafactor import _assert_params_close, _is_noise
from test_torch_train import LR, _cfgs, _tree
from torch_threads import one_torch_thread  # noqa: F401

BART_IDS = dict(pad_token_id=1, eos_token_id=2, bos_token_id=0)


def _random_states(optimizer, step=3, seed=0):
    """The same state in both packages: the JAX TrainState (parameters from
    test_torch_train's tree, optimizer statistics drawn positive from a
    seed, counts and step `step`) and the port's TrainState made from it.
    Adafactor's unused statistics (shape (1,); this tree has no parameter
    of one element) stay 0, as optax leaves them after every update."""
    jc, tc = _cfgs("eed")
    tree = _tree(jc)
    kw = dict(optimizer=optimizer, learning_rate=LR, warmup_steps=1)
    j_opt = j_trainer.make_optimizer(j_trainer.TrainConfig(**kw))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        a = np.asarray(leaf)
        if a.dtype == np.int32:
            return jnp.asarray(np.int32(step))
        if optimizer == "adafactor" and a.shape == (1,):
            return jnp.zeros(1, a.dtype)
        return jnp.asarray(rng.uniform(0.1, 2.0, a.shape).astype(a.dtype))
    opt_state = jax.tree_util.tree_map_with_path(
        fill, j_opt.init(jax.tree_util.tree_map(jnp.asarray, tree)))
    j_state = j_trainer.TrainState(
        jax.tree_util.tree_map(jnp.asarray, tree), opt_state,
        jnp.asarray(np.int32(step)))
    params = convert.params_from_jax(tree, tc)
    t_tc = t_trainer.TrainConfig(**kw)
    t_state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_tc).init(params), 0)
    return j_state, t_state


def _j_dict(state):
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step}


def _j_flat(tree):
    return {p: np.asarray(leaf) for p, leaf in j_tree_paths(tree)}


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_port_writes_the_jax_key_strings(optimizer, tmp_path):
    """The archive the port writes has the JAX archive's __paths__, in the
    same order, each leaf of the same shape and dtype."""
    j_state, t_state = _random_states(optimizer)
    j_ckpt.save_pytree_npz(str(tmp_path / "j.npz"), _j_dict(j_state))
    t_ckpt.CheckpointManager(str(tmp_path / "t")).save(5, t_state)
    want = np.load(tmp_path / "j.npz", allow_pickle=True)
    got = np.load(tmp_path / "t" / "step_5.npz", allow_pickle=True)
    assert list(got["__paths__"]) == list(want["__paths__"])
    assert len(want["__paths__"]) > 100
    for i in range(len(want["__paths__"])):
        g, w = got[f"arr_{i}"], want[f"arr_{i}"]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), want["__paths__"][i]
    with open(tmp_path / "t" / "step_5.npz.meta.json") as f:
        assert json.load(f) == {"step": 5, "metrics": {}}


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_checkpoints_restore_across_packages_bit_exact(optimizer, tmp_path):
    """JAX-written -> port and port-written -> JAX, 0 ULP."""
    j_state, _ = _random_states(optimizer, step=3, seed=1)
    _, t_state = _random_states(optimizer, step=0, seed=2)
    j_mgr = j_ckpt.CheckpointManager(str(tmp_path / "j"))
    j_mgr.save(3, _j_dict(j_state), {"eval_loss": 0.5})
    t_mgr = t_ckpt.CheckpointManager(str(tmp_path / "j"))
    restored, meta = t_mgr.restore(t_state)
    assert meta == {"step": 3, "metrics": {"eval_loss": 0.5}}
    assert restored.step == 3 and restored.opt_state["count"] == 3
    assert restored.params is t_state.params   # written in place
    want = _j_flat(_j_dict(j_state))
    got = dict(convert.flatten_with_paths(
        convert.train_state_to_jax(restored)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)

    # the port's state (moved by one step of its own, so every leaf has
    # new bits) through the JAX package's restore
    opt = t_trainer.make_optimizer(t_trainer.TrainConfig(
        optimizer=optimizer, learning_rate=LR, warmup_steps=0))
    grads = t_trainer.tree_map(torch.ones_like, restored.params)
    new_opt = opt.update_(restored.params, grads, restored.opt_state,
                          t_trainer.global_norm(grads))
    moved = t_trainer.TrainState(restored.params, new_opt, 4)
    t_ckpt.CheckpointManager(str(tmp_path / "t")).save(4, moved)
    back, meta = j_ckpt.CheckpointManager(str(tmp_path / "t")).restore(
        _j_dict(j_state))
    assert meta["step"] == 4 and int(back["step"]) == 4
    want = dict(convert.flatten_with_paths(convert.train_state_to_jax(moved)))
    got = _j_flat(back)
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
        assert got[path].dtype == w.dtype


def test_optimizer_state_bridges_invert():
    """adafactor_state_from_jax and adamw_state_from_jax undo their _to_jax
    counterparts, writing in place."""
    for optimizer in ("adafactor", "adamw"):
        _, a = _random_states(optimizer, seed=3)
        _, b = _random_states(optimizer, seed=4)
        to_jax, from_jax = (
            (convert.adafactor_state_to_jax, convert.adafactor_state_from_jax)
            if optimizer == "adafactor" else
            (convert.adamw_state_to_jax, convert.adamw_state_from_jax))
        grads = t_trainer.tree_map(torch.ones_like, a.params)
        opt = t_trainer.make_optimizer(t_trainer.TrainConfig(
            optimizer=optimizer, learning_rate=LR, warmup_steps=0))
        src = opt.update_(a.params, grads, a.opt_state,
                          t_trainer.global_norm(grads))
        leaves = [t for _, t in t_trainer.tree_paths(b.opt_state)
                  if isinstance(t, torch.Tensor)]
        out = from_jax(to_jax(src), b.opt_state)
        assert out["count"] == 1
        after = [t for _, t in t_trainer.tree_paths(out)
                 if isinstance(t, torch.Tensor)]
        assert all(x is y for x, y in zip(leaves, after))
        want = dict(convert.flatten_with_paths(to_jax(src)))
        for path, w in convert.flatten_with_paths(to_jax(out)):
            np.testing.assert_array_equal(w, want[path], err_msg=path)


def test_optional_leaf_kept_and_missing_leaf_raises(tmp_path):
    """An archive without masked_spec_embed restores with a warning and the
    live value kept; any other missing leaf raises KeyError."""
    _, t_state = _random_states("adafactor")
    tree = convert.train_state_to_jax(t_state)
    flat = {p: a for p, a in convert.flatten_with_paths(tree)
            if "masked_spec_embed" not in p}
    _, live = _random_states("adafactor", seed=5)
    before = live.params["speech_encoder"]["masked_spec_embed"].clone()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        convert.train_state_from_jax(flat, live)
    assert any("masked_spec_embed" in str(w.message) for w in rec)
    assert torch.equal(live.params["speech_encoder"]["masked_spec_embed"],
                       before)
    del flat["params/enc_to_dec_proj/kernel"]
    with pytest.raises(KeyError, match="enc_to_dec_proj"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        convert.train_state_from_jax(flat, live)


def test_prune_keeps_best_as_jax(tmp_path):
    """Save steps with eval losses in both packages' managers: the same
    files survive the pruning (the best step never pruned), the same best
    and latest steps."""
    _, t_state = _random_states("adafactor")
    j_mgr = j_ckpt.CheckpointManager(str(tmp_path / "j"), 2)
    t_mgr = t_ckpt.CheckpointManager(str(tmp_path / "t"), 2)
    for step, loss in [(1, 3.0), (2, 1.0), (3, 2.0), (4, 2.5), (5, None)]:
        metrics = {} if loss is None else {"eval_loss": loss}
        j_mgr.save(step, {"x": jnp.zeros(2)}, metrics)
        t_mgr.save(step, t_state, metrics)
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))
        assert t_mgr.best_step() == j_mgr.best_step()
        assert t_mgr.latest_step() == j_mgr.latest_step()
    assert t_mgr.best_step() == 2 and t_mgr.latest_step() == 5
    assert t_ckpt.CheckpointManager(str(tmp_path / "e")).restore(t_state) \
        == (None, None)
    # the orbax backend is the port's torch.distributed.checkpoint files:
    # one process writes step_3/ and reads it back into fresh tensors
    o_mgr = t_ckpt.CheckpointManager(str(tmp_path / "o"), backend="orbax")
    o_mgr.save(3, t_state, {"eval_loss": 1.5})
    assert sorted(os.listdir(tmp_path / "o")) == ["step_3",
                                                  "step_3.meta.json"]
    _, fresh = _random_states("adafactor", step=7, seed=1)
    got, meta = o_mgr.restore(fresh)
    assert meta["step"] == 3 and got.step == t_state.step
    assert got.opt_state["count"] == t_state.opt_state["count"]
    for field in ("params", "v_row", "v_col", "v"):
        tree_a = got.params if field == "params" else got.opt_state[field]
        tree_b = (t_state.params if field == "params"
                  else t_state.opt_state[field])
        for (_, a), (_, b) in zip(t_trainer.tree_paths(tree_a),
                                  t_trainer.tree_paths(tree_b)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        t_ckpt.CheckpointManager(str(tmp_path / "o"), backend="zarr")


# ---------------------------------------------------------------------------
# resume through Trainer.fit from a JAX-written checkpoint
# ---------------------------------------------------------------------------

def _examples(n, seed):
    rng = np.random.RandomState(seed)
    return [{"input_values": (rng.randn(7000 + 100 * i) * 0.1).astype(
                 np.float32),
             "labels": [0] + list(rng.randint(130, 300, 4 + i % 5)) + [2]}
            for i in range(n)]


def _batchers(coll):
    kw = dict(buckets_sec=(0.5,), max_label_length=12, pad_token_id=1,
              bos_token_id=0, eos_token_id=2)
    train, evals = _examples(8, 0), _examples(4, 1)
    t = coll.BucketBatcher(coll.CollatorConfig(**kw), 4, shuffle_seed=3)
    e = coll.BucketBatcher(coll.CollatorConfig(**kw), 4)
    return (lambda: t(train)), (lambda: e(evals))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


RESUME_TC = dict(learning_rate=LR, warmup_steps=1, max_steps=3,
                 num_epochs=2, eval_steps=2, logging_steps=1,
                 save_total_limit=2, dropout=False, prefetch_depth=2)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Both packages' fit from the same JAX-written step-1 checkpoint."""
    root = tmp_path_factory.mktemp("resume")
    j_state, t_state = _random_states("adafactor", step=1, seed=6)
    j_ckpt.CheckpointManager(str(root / "start")).save(1, _j_dict(j_state))
    for side in ("j", "t"):
        shutil.copytree(root / "start", root / side)
    jc, tc = _cfgs("eed")
    j_tr = j_trainer.Trainer(
        jc, j_trainer.TrainConfig(output_dir=str(root / "j"),
                                  use_flash=False, **RESUME_TC),
        tokenizer=j_tok.ByteTokenizer(**BART_IDS),
        mesh=mesh_lib.make_mesh(n_data=1))
    # start from other values: the restore must overwrite every leaf
    fresh = jax.tree_util.tree_map(jnp.zeros_like, j_state)
    j_final = j_tr.fit(fresh, *_batchers(j_coll))
    t_tr = t_trainer.Trainer(
        tc, t_trainer.TrainConfig(output_dir=str(root / "t"), **RESUME_TC),
        tokenizer=j_tok.ByteTokenizer(**BART_IDS), device="cpu")
    from speechmix_tpu_torch.data import collator as t_coll
    t_final = t_tr.fit(t_state, *_batchers(t_coll))
    return root, j_final, t_final


def test_fit_resumes_a_jax_checkpoint_as_jax_does(resumed):
    root, j_final, t_final = resumed
    want = _records(root / "j" / "metrics.jsonl")
    got = _records(root / "t" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert want[0] == {"resumed_from_step": 1}
    assert {"step": 3, "max_steps_reached": True}.items() <= want[-2].items()
    assert want[-1] == {"loaded_best_model_from_step": 2}
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "elapsed":
                continue
            if k in ("loss", "grad_norm", "eval_loss"):
                assert abs(g[k] - v) <= 1e-4 * abs(v), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)
    assert sorted(os.listdir(root / "t")) == sorted(os.listdir(root / "j"))
    assert t_final.step == int(j_final.step) == 2


def test_one_step_from_a_jax_checkpoint_matches_the_jax_step(resumed):
    """The step-2 checkpoints: one Adafactor step from the JAX-written
    step-1 state in each package; the final state is step 2 restored."""
    root, j_final, t_final = resumed
    want = t_ckpt.load_pytree_npz(str(root / "j" / "step_2.npz"))
    got = t_ckpt.load_pytree_npz(str(root / "t" / "step_2.npz"))
    assert got.keys() == want.keys()
    steps = 1
    for path, w in want.items():
        g = got[path]
        if not path.startswith("params/"):
            if g.dtype == np.int32:
                assert g == w, path
                continue
            limit = 1e-10 if _is_noise(path) else 1e-3 * np.abs(w).max()
            assert np.abs(g - w).max() <= limit, path
            continue
        diff = (g - w).astype(np.float64)
        if _is_noise(path):
            assert np.sqrt(np.mean(diff ** 2)) <= 2 * LR * steps, path
        else:
            assert np.abs(diff).max() <= 1e-4 * np.abs(w).max() + 2e-6, path
    _assert_params_close(t_final.params, j_final.params, steps)
