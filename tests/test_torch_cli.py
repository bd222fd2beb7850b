"""The port's commands (``python -m speechmix_tpu_torch.train`` / ``.eval``)
against the root ``train.py`` / ``eval.py`` of the JAX package, on the CPU.

The flags: ``parse_args`` (options and pass-through kwargs) and ``_coerce``
equal the root script's for a set of command lines, and so do the
TrainConfig fields that ``main`` builds (the JAX package's ``use_flash``
aside); the flags of what is not ported raise; without ``--platform cpu``
both commands ask for the card and raise when CUDA is absent.

End to end, float32: the train command on a tiny wav2vec2 config directory
(strides giving 100 frames in the synthetic corpus's 4 s bucket; the
command's --speech_model_config takes a checkpoint directory) +
tiny-bart-bytes, 3 AdamW steps without dropout, both ``pick_model``s
patched to start from the same weights (``params_from_jax``): the logged
losses and gradient norms, and the final_weights.npz files, within
test_torch_train.py's limits (1e-4 relative + 2e-6; the attention key
biases, whose gradient is rounding noise, the learning rate per step).  The eval command on an npz the JAX model saved: the
``--synthetic_eval`` JSON and the one-utterance ``decoded:`` line equal to
the root script's, token for token.
"""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from speechmix_tpu_torch import convert
from speechmix_tpu_torch import eval as t_eval
from speechmix_tpu_torch import train as t_train
from speechmix_tpu_torch.training.checkpoint import load_pytree_npz
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

TINY_W2V = {
    "model_type": "wav2vec2", "conv_dim": [32, 32, 32, 32],
    "conv_kernel": [10, 8, 4, 4], "conv_stride": [5, 8, 4, 4],
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "intermediate_size": 128, "num_conv_pos_embeddings": 16,
    "num_conv_pos_embedding_groups": 4, "apply_spec_augment": False,
    "layerdrop": 0.0}


def _root(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots():
    return _root("train"), _root("eval")


@pytest.fixture
def tiny_w2v(tmp_path):
    d = tmp_path / "tiny_w2v"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(TINY_W2V))
    return str(d)


ARGVS = [
    [],
    ["--HFSpeechMixEED", "--speech_model_config", "tiny-speech",
     "--nlp_model_config", "tiny-bart-bytes", "--down_scale", "2",
     "--synthetic", "--batch", "8", "--grad_accum", "1", "--max_steps", "3",
     "--bf16", "--no-dropout", "--platform", "cpu", "--fixed_speech",
     "False", "--alpha", "0.5", "--tag", "x1"],
    ["--SpeechMixFixed", "--fp16", "--unfreeze_warmup_steps", "5",
     "--lr_scheduler", "cosine", "--optimizer", "adamw",
     "--predict_with_generate", "--num_beams", "4", "--no-group_by_length",
     "--no-load_best_model_at_end", "--stall_timeout", "60",
     "--fixed_except", "layer_norm", "encoder_attn", "--fixed_nlp", "true",
     "--flash_attention", "--wandb", "--eval_step", "7", "--seed", "3"],
    ["--SpeechMixGAN", "--weighted_sum", "--share_layer_ratio", "0.5",
     "--checkpoint_backend", "npz", "--no-flash_attention", "--epoch", "2",
     "--save_total_limit", "4", "--max_grad_norm", "1.5", "--warmup_steps",
     "0", "--logging_steps", "1", "--output_dir", "out", "--notes", "n"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_root(argv, roots):
    root_train, _ = roots
    got, got_other = t_train.parse_args(argv)
    want, want_other = root_train.parse_args(argv)
    assert vars(got) == vars(want)
    assert got_other == want_other
    assert t_train.MODEL_FLAGS == root_train.MODEL_FLAGS


@pytest.mark.parametrize("value", ["True", "false", "FALSE", "3", "-2",
                                   "0.5", "1e-3", "nan", "inf", "x1",
                                   "tiny-bart-bytes", ""])
def test_coerce_matches_root(value, roots):
    got, want = t_train._coerce(value), roots[0]._coerce(value)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)


class _Stop(Exception):
    pass


def _captured_train_config(main, trainer_mod, datasets_mod, argv,
                           monkeypatch):
    """The TrainConfig that `main` hands its Trainer, with the datasets
    stubbed out and the Trainer stopped at construction."""
    seen = {}

    def stop(cfg, tc, **kw):
        seen["tc"] = tc
        raise _Stop
    monkeypatch.setattr(trainer_mod, "Trainer", stop)
    monkeypatch.setattr(datasets_mod, "build_datasets",
                        lambda *a, **kw: (None, None))
    with pytest.raises(_Stop):
        main(argv)
    return seen["tc"]


@pytest.mark.parametrize("argv", ARGVS[1:])
def test_train_config_matches_root(argv, roots, monkeypatch):
    from speechmix_tpu.data import datasets as j_ds
    from speechmix_tpu.training import trainer as j_trainer
    from speechmix_tpu.utils import compile_cache
    from speechmix_tpu_torch.data import datasets as t_ds
    from speechmix_tpu_torch.training import trainer as t_trainer
    monkeypatch.setattr(compile_cache, "setup_compile_cache",
                        lambda *a, **kw: None)
    tiny = ["--speech_model_config", "tiny-speech", "--nlp_model_config",
            "tiny-bart-bytes", "--platform", "cpu"]
    argv = argv + tiny
    got = dataclasses.asdict(_captured_train_config(
        t_train.main, t_trainer, t_ds, argv, monkeypatch))
    want = dataclasses.asdict(_captured_train_config(
        roots[0].main, j_trainer, j_ds, argv, monkeypatch))
    assert want.pop("use_flash") == t_train.parse_args(
        argv)[0].flash_attention
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--model_parallel", "2"], ["--sequence_parallel", "4"], ["--zero1"],
    ["--multihost"], ["--checkpoint_backend", "orbax"]])
def test_unported_flags_raise(flags, roots, monkeypatch):
    """The parallelism flags are ported: each reaches the Trainer's
    TrainConfig as the root command's does.  One process with
    --model_parallel / --sequence_parallel above 1 has no ranks for the
    mesh and stops at the JAX package's mesh assertion, as the root
    command does on too few devices."""
    from speechmix_tpu.data import datasets as j_ds
    from speechmix_tpu.training import trainer as j_trainer
    from speechmix_tpu.utils import compile_cache
    from speechmix_tpu_torch.data import datasets as t_ds
    from speechmix_tpu_torch.parallel import mesh as t_mesh
    from speechmix_tpu_torch.training import trainer as t_trainer
    monkeypatch.setattr(compile_cache, "setup_compile_cache",
                        lambda *a, **kw: None)
    argv = flags + ["--speech_model_config", "tiny-speech",
                    "--nlp_model_config", "tiny-bart-bytes",
                    "--platform", "cpu"]
    if "--model_parallel" in flags or "--sequence_parallel" in flags:
        with pytest.raises(AssertionError,
                           match="exceeds the device count"):
            t_mesh.make_mesh(n_model=int(flags[1]), device="cpu")
        monkeypatch.setattr(t_train, "_world_size", lambda: 1)
        monkeypatch.setattr(t_mesh, "make_mesh",
                            lambda **kw: t_mesh.Mesh(1, 1, 1, device="cpu"))
    got = dataclasses.asdict(_captured_train_config(
        t_train.main, t_trainer, t_ds, argv, monkeypatch))
    root_argv = [a for a in argv if a != "--multihost"]
    want = dataclasses.asdict(_captured_train_config(
        roots[0].main, j_trainer, j_ds, root_argv, monkeypatch))
    want.pop("use_flash")
    assert got == want


def test_commands_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = ["--speech_model_config", "tiny-speech", "--nlp_model_config",
            "tiny-bart-bytes", "--down_scale", "2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(tiny + ["--synthetic", "--max_steps", "1",
                             "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_eval.main(tiny + ["--max_length", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_eval.main(tiny + ["--max_length", "2", "--platform", "gpu"])


def _log_records(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and '"grad_norm"' in line]


def test_train_command_matches_root(roots, tiny_w2v, tmp_path, capsys,
                                    monkeypatch):
    from speechmix_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "setup_compile_cache",
                        lambda *a, **kw: None)
    root_train, _ = roots
    models = {}

    def jax_pick(input_args, other):
        name, model = real_jax_pick(input_args, other)
        models["jax"] = jax.tree_util.tree_map(np.asarray, model.params)
        return name, model

    def port_pick(input_args, other):
        name, model = real_port_pick(input_args, other)
        model.params = convert.params_from_jax(models["jax"], model.config)
        return name, model
    real_jax_pick, real_port_pick = root_train.pick_model, t_train.pick_model
    monkeypatch.setattr(root_train, "pick_model", jax_pick)
    monkeypatch.setattr(t_train, "pick_model", port_pick)
    argv = ["--HFSpeechMixEED", "--speech_model_config", tiny_w2v,
            "--nlp_model_config", "tiny-bart-bytes", "--down_scale", "2",
            "--synthetic", "--batch", "8", "--grad_accum", "1",
            "--max_steps", "3", "--logging_steps", "1", "--no-dropout",
            "--no-flash_attention", "--lr", "1e-3", "--warmup_steps", "1",
            "--optimizer", "adamw", "--platform", "cpu"]
    logs = {}
    for name, main in (("jax", root_train.main), ("port", t_train.main)):
        out = tmp_path / name
        main(argv + ["--output_dir", str(out)])
        logs[name] = _log_records(capsys.readouterr().out)
        assert (out / "final_weights.npz").exists()
    assert [r["step"] for r in logs["port"]] == [1, 2, 3]
    assert [r["step"] for r in logs["jax"]] == [1, 2, 3]
    for got, want in zip(logs["port"], logs["jax"]):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]) + \
                2e-6, (got, want)
    # the final weights in the JAX npz layout, as test_torch_train.py holds
    # parameters after steps (the attention key biases' gradient is
    # rounding noise: held to the learning rate per step)
    want = load_pytree_npz(str(tmp_path / "jax" / "final_weights.npz"))
    got = load_pytree_npz(str(tmp_path / "port" / "final_weights.npz"))
    assert list(got) == list(want)
    for path, ref in want.items():
        limit = (3 * 1e-3 if "k_proj" in path and "bias" in path
                 else 1e-4 * np.abs(ref).max() + 2e-6)
        assert got[path].shape == ref.shape and got[path].dtype == \
            np.float32, path
        assert np.abs(got[path] - ref).max() <= limit, path


def _run_root_eval(root_eval, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
    root_eval.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", [
    ["--synthetic_eval", "8", "--batch", "8", "--beam", "2"],
    ["--max_length", "12"]], ids=["synthetic_eval-beam-2", "one-utterance"])
def test_eval_command_matches_root(mode, roots, tiny_w2v, tmp_path, capsys,
                                   monkeypatch):
    """Both commands on one npz that the JAX package saved: weights drawn
    at std 0.3, every logit but those of ten ASCII bytes lowered, so that
    rows decode text."""
    from speechmix_tpu import api as j_api
    from speechmix_tpu.utils import compile_cache
    monkeypatch.setattr(compile_cache, "setup_compile_cache",
                        lambda *a, **kw: None)
    _, root_eval = roots
    model = j_api.HFSpeechMixEED(tiny_w2v, "tiny-bart-bytes", down_scale=2)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32)
        if a.ndim >= 2 else np.asarray(a), model.params)
    letters = [model.tokenizer.BYTE_OFFSET + b for b in b" etaoinshr"]
    bias = np.full_like(np.asarray(params["nlp"]["final_logits_bias"]),
                        -1e4)
    bias[letters] = 0.0
    params["nlp"]["final_logits_bias"] = bias
    model.params = params
    weights = str(tmp_path / "w.npz")
    model.save_weights(weights)
    argv = ["--speech_model_config", tiny_w2v, "--nlp_model_config",
            "tiny-bart-bytes", "--down_scale", "2", "--weights", weights,
            "--max_length", "12", "--platform", "cpu"] + mode
    want = _run_root_eval(root_eval, argv, capsys, monkeypatch)
    t_eval.main(argv)
    got = capsys.readouterr().out
    assert got == want
    if "--synthetic_eval" in mode:
        metrics = json.loads(got.strip().splitlines()[-1])
        assert metrics["n_examples"] == 8 and metrics["predict_cer"] > 0
    else:
        decoded = [l for l in got.splitlines() if l.startswith("decoded:")]
        assert len(decoded) == 1 and len(decoded[0]) > len("decoded: ")
