"""The port's loop around the train step against the JAX package's, float32
on the CPU: the eval step, Trainer.evaluate and Trainer.predict, and one
whole Trainer.fit.

Tolerances.  Eval step: loss 1e-5 relative, argmax predictions, token and
example counts exact.  evaluate: eval_loss 1e-5 relative, CER / WER of the
argmax predictions exact; predict: the greedy tokens' WER / CER and the
example count exact.  fit (AdamW at a learning rate high enough that the
eval loss rises again, dropout off, one bucket, freeze_epochs 1 so that the
second epoch runs at progress 1, eval every step, patience 2): the logged
records equal key for key (losses, gradient norms and eval losses 1e-4
relative, CER / WER exact), the early-stop and best-model records and the
kept checkpoint files the same; the final parameters (the best step,
restored) within test_torch_train.py's limits, 1e-4 relative + 2e-6, the
attention key biases (a gradient that is rounding noise) within twice the
learning rate per step.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speechmix_tpu.data import collator as j_coll
from speechmix_tpu.data import datasets as j_ds
from speechmix_tpu.data import tokenizer as j_tok
from speechmix_tpu.parallel import mesh as mesh_lib
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.data import collator as t_coll
from speechmix_tpu_torch.data import tokenizer as t_tok
from speechmix_tpu_torch.training import trainer as t_trainer
from speechmix_tpu_torch.utils import watchdog as t_watchdog
from test_torch_checkpoint import _batchers, _records
from test_torch_slice import _tree as _slice_tree
from test_torch_train import _assert_trees_close, _cfgs, _tree
from torch_threads import one_torch_thread  # noqa: F401

BART_IDS = dict(pad_token_id=1, eos_token_id=2, bos_token_id=0)


def _eval_batches(coll, tok):
    """Two batches of 3 utterances of 0.85-0.9 s with byte-tokenized
    transcripts: one full, one with a filler row."""
    raw = j_ds.synthetic_corpus(5, seed=7, min_sec=0.4, max_sec=0.9,
                                min_words=1, max_words=2)
    examples = [{"input_values": r["audio"],
                 "labels": tok.encode(r["text"]) + [BART_IDS["eos_token_id"]]}
                for r in raw]
    cfg = coll.CollatorConfig(buckets_sec=(1.0,), max_label_length=16,
                              **BART_IDS)
    batcher = coll.BucketBatcher(cfg, 3)
    return lambda: batcher(examples)


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs("eed")
    tree = _slice_tree(jc, 0.3, seed=1)
    kw = dict(learning_rate=1e-3, warmup_steps=1, dropout=False,
              output_dir="")
    j_tr = j_trainer.Trainer(jc, j_trainer.TrainConfig(use_flash=False, **kw),
                             tokenizer=j_tok.ByteTokenizer(**BART_IDS),
                             mesh=mesh_lib.make_mesh(n_data=1))
    t_tr = t_trainer.Trainer(tc, t_trainer.TrainConfig(**kw),
                             tokenizer=t_tok.ByteTokenizer(**BART_IDS),
                             device="cpu")
    j_eval = j_trainer.make_eval_step(jc, j_tr.tc)
    t_eval = t_trainer.make_eval_step(tc, t_tr.tc, device="cpu")
    return dict(jc=jc, tc=tc, j_params=jax.tree_util.tree_map(jnp.asarray,
                                                              tree),
                t_params=convert.params_from_jax(tree, tc), j_tr=j_tr,
                t_tr=t_tr, j_eval=j_eval, t_eval=t_eval)


def test_eval_step_matches_jax(setup):
    batch = next(iter(_eval_batches(j_coll, j_tok.ByteTokenizer(
        **BART_IDS))()))
    batch["example_mask"] = np.array([True, False, True])
    want = setup["j_eval"](setup["j_params"],
                           {k: jnp.asarray(v) for k, v in batch.items()})
    got = setup["t_eval"](setup["t_params"], batch)
    ref = float(want["loss"])
    assert abs(got["loss"].item() - ref) <= 1e-5 * abs(ref), (
        got["loss"].item(), ref)
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))
    assert int(got["n_tokens"]) == int(want["n_tokens"]) > 0
    assert int(got["n_examples"]) == int(want["n_examples"]) == 2


def test_evaluate_and_predict_match_jax(setup):
    j_tr, t_tr = setup["j_tr"], setup["t_tr"]
    want = j_tr.evaluate(setup["j_params"], setup["j_eval"],
                         _eval_batches(j_coll, j_tr.tokenizer))
    got = t_tr.evaluate(setup["t_params"], setup["t_eval"],
                        _eval_batches(t_coll, t_tr.tokenizer))
    assert got.keys() == want.keys() == {"eval_loss", "cer", "wer"}
    assert abs(got["eval_loss"] - want["eval_loss"]) <= \
        1e-5 * abs(want["eval_loss"])
    assert (got["cer"], got["wer"]) == (want["cer"], want["wer"])
    want = j_tr.predict(setup["j_params"],
                        _eval_batches(j_coll, j_tr.tokenizer), max_length=8)
    got = t_tr.predict(setup["t_params"],
                       _eval_batches(t_coll, t_tr.tokenizer), max_length=8)
    assert got == want
    assert want["n_examples"] == 5 and 0 < want["predict_cer"]


FIT_TC = dict(learning_rate=0.02, optimizer="adamw", warmup_steps=1,
              num_epochs=3, eval_steps=1, logging_steps=1,
              early_stopping_patience=2, freeze_epochs=1, dropout=False,
              save_total_limit=2)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    jc, tc = _cfgs("eed")
    tree = _tree(jc)
    j_tc = j_trainer.TrainConfig(output_dir=str(root / "j"), use_flash=False,
                                 **FIT_TC)
    j_tr = j_trainer.Trainer(jc, j_tc,
                             tokenizer=j_tok.ByteTokenizer(**BART_IDS),
                             mesh=mesh_lib.make_mesh(n_data=1))
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_trainer.TrainState(
        j_params, j_trainer.make_optimizer(j_tc).init(j_params),
        jnp.zeros((), jnp.int32))
    j_final = j_tr.fit(j_state, *_batchers(j_coll))
    t_tc = t_trainer.TrainConfig(output_dir=str(root / "t"), **FIT_TC)
    t_tr = t_trainer.Trainer(tc, t_tc,
                             tokenizer=t_tok.ByteTokenizer(**BART_IDS),
                             device="cpu")
    params = convert.params_from_jax(tree, tc)
    t_state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_tc).init(params), 0)
    t_final = t_tr.fit(t_state, *_batchers(t_coll))
    return root, j_final, t_final


def test_fit_logs_the_jax_records(fitted):
    root, _, _ = fitted
    want = _records(root / "j" / "metrics.jsonl")
    got = _records(root / "t" / "metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "elapsed":
                continue
            if k in ("loss", "grad_norm", "eval_loss"):
                assert abs(g[k] - v) <= 1e-4 * abs(v), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)
    # two epochs of two steps, then the early stop; the second epoch at
    # progress 1
    assert [r["epoch"] for r in want if "epoch" in r] == [0, 0, 1, 1]
    assert want[-2] == {"early_stop": True, "best_step": 2}
    assert want[-1] == {"loaded_best_model_from_step": 2}
    assert sorted(os.listdir(root / "t")) == sorted(os.listdir(root / "j"))


def test_fit_final_params_match_jax(fitted):
    _, j_final, t_final = fitted
    assert t_final.step == int(j_final.step) == 2
    assert t_final.opt_state["count"] == int(j_final.opt_state[1][0].count)
    _assert_trees_close(t_final.params, j_final.params, 1e-4, 2e-6,
                        noise_atol=2 * FIT_TC["learning_rate"] * 2)


def test_trainer_wires_the_watchdog(tmp_path, monkeypatch):
    """stall_timeout_s > 0: fit starts a StallWatchdog with the metrics
    file as its log, beats it before every step and eval batch, and stops
    it at the end."""
    events = []

    class Recorder:
        def __init__(self, timeout_s):
            events.append(("init", timeout_s))
            self.log_path = None

        def start(self):
            events.append(("start", self.log_path))

        def beat(self):
            events.append(("beat",))

        def stop(self):
            events.append(("stop",))

    monkeypatch.setattr(t_watchdog, "StallWatchdog", Recorder)
    jc, tc = _cfgs("eed")
    tc = dataclasses.replace(tc, encoder=dataclasses.replace(
        tc.encoder, num_layers=1))
    t_tc = t_trainer.TrainConfig(output_dir=str(tmp_path), max_steps=2,
                                 eval_steps=2, dropout=False,
                                 stall_timeout_s=30.0, prefetch_depth=0)
    tr = t_trainer.Trainer(tc, t_tc, device="cpu")
    tr.fit(tr.init_state(), *_batchers(t_coll))
    log = str(tmp_path / "metrics.jsonl")
    assert events[0] == ("init", 30.0) and events[1] == ("start", log)
    assert events[-1] == ("stop",)
    # two steps and one eval batch
    assert events.count(("beat",)) == 3


def test_watchdog_fires_and_stops():
    """The port's StallWatchdog: silent while beaten, fires once beats stop,
    the JAX package's exit status."""
    from speechmix_tpu.utils import watchdog as j_watchdog
    assert t_watchdog.STALL_EXIT_CODE == j_watchdog.STALL_EXIT_CODE
    fired = []
    wd = t_watchdog.StallWatchdog(0.3, on_stall=fired.append, poll_s=0.02)
    wd.start()
    for _ in range(10):
        wd.beat()
        time.sleep(0.05)
    assert not wd.fired and not fired
    deadline = time.time() + 5
    while not wd.fired and time.time() < deadline:
        time.sleep(0.02)
    wd.stop()
    assert wd.fired and len(fired) == 1 and fired[0] >= 0.3
