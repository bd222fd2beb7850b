"""Multi-process runs of the port (the counterpart of
``tests/test_multihost.py``), 4 gloo processes on the CPU:

* ``build_datasets(multihost=True)`` over (2, 1, 1): each rank batches the
  whole synthetic corpus with one seed and keeps its data rank's rows; the
  DP losses of two steps equal one process's steps on the whole batches,
  and both ranks see the same schedule of shapes (one speech layer: the
  corpus's 4 s buckets make the plain attention slow on the CPU);
* checkpoints under ZeRO-1 + tensor parallelism at (2, 2, 1) (AdamW):
  ``Trainer.fit`` to step 2, then fresh processes resume from the step-2
  checkpoint and run steps 3-4 (one fixed batch of 4 rows every step); the resumed run ends where an
  uninterrupted 4-step run ends, bit for bit, with the npz backend and
  with the port's sharded "orbax" backend (torch.distributed.checkpoint);
* the npz written under ZeRO-1 + TP (rank 0, the whole state gathered)
  loads in the JAX package's ``CheckpointManager``, parameters equal to
  the port's, and the orbax-counterpart directory holds one file per
  writing rank, no gathered copy;
* the train command as 4 torchrun ranks (``--model_parallel 2 --zero1``,
  gloo with ``--platform cpu``) logs, on rank 0 only, the losses of one
  process over the same global batches, and rank 0 alone writes the
  final weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.training import checkpoint as j_ckpt
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu import config as jcfg
from speechmix_tpu_torch.data.datasets import build_datasets
from speechmix_tpu_torch.parallel import launch
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_worker

TC = dict(learning_rate=1e-3, warmup_steps=0, lr_schedule="constant",
          dropout=False,
          optimizer="adamw", fixed_nlp=False, prefetch_depth=0,
          logging_steps=1, eval_steps=2, save_total_limit=2,
          load_best_model_at_end=False, num_epochs=1,
          predict_with_generate=True)


def _cfg(down_scale):
    return jcfg.SpeechMixConfig(encoder=jcfg.SPEECH_ENCODER_PRESETS[
        "tiny-speech"], decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
        down_scale=down_scale)


@pytest.fixture(scope="module")
def tree():
    """The corpus test's tree (down_scale 8) and the fit runs' (2)."""
    return (_tree(_cfg(torch_mesh_worker.DATA_DOWN_SCALE), 0.1, seed=4),
            _tree(_cfg(2), 0.1, seed=4))


def _fit_batches():

    def batch(rows, seed):
        r = np.random.RandomState(seed)
        wav = (r.randn(rows, 6000) * 0.1).astype(np.float32)
        labels = r.randint(3, 384, size=(rows, 8)).astype(np.int32)
        labels[1, 5:] = -100
        return {"input_values": wav, "lengths": np.full(rows, 6000, np.int32),
                "labels": labels}
    return batch(4, 1), [batch(4, 2), batch(4, 3)]


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    base = tmp_path_factory.mktemp("multihost")
    dirs = {k: str(base / k) for k in ("full", "npz", "orbax")}
    tc = lambda d, steps, backend="npz": dict(
        TC, output_dir=d, max_steps=steps, zero1=True, model_parallel=2,
        checkpoint_backend=backend)
    first = [{"mesh": (2, 2, 1), "tc": tc(dirs["full"], 4)},
             {"mesh": (2, 2, 1), "tc": tc(dirs["npz"], 2)},
             {"mesh": (2, 2, 1), "tc": tc(dirs["orbax"], 2, "orbax")}]
    resumed = [dict(first[1], tc=tc(dirs["npz"], 4)),
               dict(first[2], tc=tc(dirs["orbax"], 4, "orbax"))]
    store = lambda: launch.file_store(base)
    data = launch.spawn(torch_mesh_worker.multihost_data, 4,
                        (tree[0], 2, dict(TC, fixed_nlp=False)),
                        init_method=store(), timeout_s=240)
    batch, evals = _fit_batches()
    fit1 = launch.spawn(torch_mesh_worker.fit_runs, 4,
                        (tree[1], batch, evals, first),
                        init_method=store(), timeout_s=300)
    fit2 = launch.spawn(torch_mesh_worker.fit_runs, 4,
                        (tree[1], batch, evals, resumed),
                        init_method=store(), timeout_s=300)
    return {"dirs": dirs, "data": data, "fit1": fit1, "fit2": fit2}


def _losses(directory):
    out = {}
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec and "step" in rec and "epoch" in rec:
                out[rec["step"]] = rec["loss"]
    return out


def test_multihost_data_matches_one_process(runs, tree):
    ranks = [r for r in runs["data"] if r is not None]
    assert len(ranks) == 2
    assert ranks[0]["shapes"] == ranks[1]["shapes"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    model = torch_mesh_worker._tiny_model(
        tree[0], torch_mesh_worker.DATA_DOWN_SCALE,
        torch_mesh_worker.DATA_SPEECH_LAYERS)
    train, _ = build_datasets(torch_mesh_worker._Args(batch=4), model,
                              device="cpu")
    tc = t_trainer.TrainConfig(**TC)
    state = t_trainer.TrainState(
        model.params, t_trainer.make_optimizer(tc).init(model.params), 0)
    step = t_trainer.make_train_step(model.config, tc, model.params,
                                     device="cpu")
    single = []
    for batch, shapes in zip(train(), ranks[0]["shapes"]):
        assert all(np.asarray(v).shape[0] == 2 * shapes[k][0]
                   for k, v in batch.items())
        state, m = step(state, batch)
        single.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], single, rtol=1e-5)


def test_resume_equals_uninterrupted(runs):
    full = [r for r in runs["fit1"] if r is not None][0][0]
    assert full["step"] == 4
    want = _losses(runs["dirs"]["full"])
    for k, name in enumerate(("npz", "orbax")):
        first = _losses(runs["dirs"][name])
        resumed = [r[k] for r in runs["fit2"] if r[k] is not None]
        assert all(r["step"] == 4 for r in resumed)
        assert [first[s] for s in (1, 2)] == [want[s] for s in (1, 2)]
        assert [first[s] for s in (3, 4)] == [want[s] for s in (3, 4)], \
            name
        for path, a in full["params"].items():
            np.testing.assert_array_equal(resumed[0]["params"][path], a,
                                          err_msg=f"{name} {path}")


def test_npz_loads_in_the_jax_manager(runs, tree):
    """The npz of step 2 (ZeRO-1 + TP, gathered, written by rank 0) loads
    into the JAX package's CheckpointManager; its parameters are the
    port's at step 2 (the uninterrupted run's step-2 checkpoint)."""
    j_tc = j_trainer.TrainConfig(optimizer="adamw")
    params = jax.tree_util.tree_map(jnp.asarray, tree[1])
    like = {"params": params,
            "opt_state": j_trainer.make_optimizer(j_tc).init(params),
            "step": jnp.zeros((), jnp.int32)}
    manager = j_ckpt.CheckpointManager(runs["dirs"]["npz"])
    assert manager.latest_step() == 4
    restored, meta = manager.restore(like, step=4)
    assert int(restored["step"]) == 4 and meta["step"] == 4
    full = [r for r in runs["fit1"] if r is not None][0][0]["params"]
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(restored["params"])[0]}
    assert flat.keys() == full.keys()
    for path, a in full.items():
        np.testing.assert_array_equal(flat[path], a, err_msg=path)
    mu = jax.tree_util.tree_leaves(restored["opt_state"])
    assert any(np.abs(np.asarray(x)).max() > 0 for x in mu)


def test_eval_records_over_the_mesh(runs):
    """evaluate and predict over (2, 2, 1) gather every data rank's rows:
    rank 0's eval records count all 8 rows of the two eval batches."""
    with open(os.path.join(runs["dirs"]["full"], "metrics.jsonl")) as f:
        evals = [json.loads(l) for l in f if '"eval_loss"' in l]
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        assert r["n_examples"] == 8
        assert np.isfinite(r["eval_loss"]) and 0 <= r["predict_cer"]


def test_orbax_counterpart_writes_shards(runs):
    d = runs["dirs"]["orbax"]
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_")
                   and not n.endswith(".json"))
    assert steps == ["step_2", "step_4"]
    files = [n for n in os.listdir(os.path.join(d, "step_4"))
             if n.endswith(".distcp")]
    assert len(files) >= 2, files
    with open(os.path.join(d, "step_4.meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 4


TINY_W2V = {
    "model_type": "wav2vec2", "conv_dim": [32, 32, 32, 32],
    "conv_kernel": [10, 8, 4, 4], "conv_stride": [5, 8, 4, 4],
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "intermediate_size": 128, "num_conv_pos_embeddings": 16,
    "num_conv_pos_embedding_groups": 4, "apply_spec_augment": False,
    "layerdrop": 0.0}


def _records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and '"grad_norm"' in line]


def test_train_command_over_ranks(tmp_path, capsys):
    from speechmix_tpu_torch import train as t_train
    w2v = tmp_path / "tiny_w2v"
    w2v.mkdir()
    (w2v / "config.json").write_text(json.dumps(TINY_W2V))
    argv = ["--HFSpeechMixEED", "--speech_model_config", str(w2v),
            "--nlp_model_config", "tiny-bart-bytes", "--down_scale", "2",
            "--synthetic", "--grad_accum", "1", "--max_steps", "2",
            "--logging_steps", "1", "--no-dropout", "--lr", "1e-3",
            "--warmup_steps", "0", "--optimizer", "adamw",
            "--lr_scheduler", "constant", "--platform", "cpu",
            "--eval_step", "100"]
    outs = launch.spawn(
        torch_mesh_worker.train_command, 4,
        (argv + ["--batch", "2", "--model_parallel", "2", "--zero1",
                 "--output_dir", str(tmp_path / "mesh")], 4),
        init_method=launch.file_store(tmp_path), timeout_s=240)
    t_train.main(argv + ["--batch", "4", "--output_dir",
                         str(tmp_path / "one")])
    single = _records(capsys.readouterr().out)
    ranked = [_records(out) for out in outs]
    assert [r["step"] for r in ranked[0]] == [1, 2]
    assert all(not recs for recs in ranked[1:])
    for got, want in zip(ranked[0], single):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), \
                (key, got, want)
    assert (tmp_path / "mesh" / "final_weights.npz").exists()
