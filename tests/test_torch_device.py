"""Device rules of the PyTorch port: it runs on the card unless asked for
the CPU, imports nothing of JAX or the JAX package, and its kernel wrappers
launch or raise for a non-CPU tensor, never falling back to plain code."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops.kernels import _cuda
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import beam_gather as t_bg
from speechmix_tpu_torch.ops.kernels import conv_extractor as t_conv
from speechmix_tpu_torch.ops.kernels import decode_attention as t_da
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from speechmix_tpu_torch.training import trainer as t_trainer
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _tiny_cfg():
    return tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)


def test_generate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    wav = np.zeros((1, 4000), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gen.generate(params, cfg, wav, max_length=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gen.generate(params, cfg, wav, max_length=4, num_beams=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gen.generate(params, cfg, wav, max_length=4, kv_int8=True)
    tok, _ = t_gen.generate(params, cfg, wav, max_length=4, device="cpu")
    assert tok.shape == (1, 4)


@pytest.fixture(scope="module")
def tiny_params():
    return t_smx.init_speechmix(_tiny_cfg(), torch.Generator().manual_seed(0),
                                "cpu")


@pytest.mark.parametrize("kwargs,through_jax", [
    (dict(num_beams=2, do_sample=True, force_words_ids=[[5]]), True),
    (dict(num_beams=4, num_beam_groups=2, force_words_ids=[[5]]), True),
    (dict(num_beams=2, num_beam_groups=3), True),
    (dict(num_beam_groups=2, diversity_penalty=0.5), True),
    (dict(num_beams=4, num_beam_groups=3), False),
    (dict(num_beams=4, num_beam_groups=2, do_sample=True), False),
    (dict(num_beams=4, num_beam_groups=2, num_return_sequences=5), False),
    (dict(num_beams=2, num_return_sequences=3), False),
    (dict(num_return_sequences=2), False),
    (dict(force_words_ids=[[5]]), False),
    (dict(num_beams=2, force_words_ids=[[5]], num_return_sequences=3),
     False),
    (dict(num_beams=2, force_words_ids=[]), False),
    (dict(num_beams=2, force_words_ids=[[5, -6]]), False),
    (dict(num_beams=2, force_words_ids=[[[4, 5], [4]]]), False)])
def test_generate_contract_errors(tiny_params, kwargs, through_jax):
    """Argument sets that both packages' generate() reject with HF's
    ValueError; the first few (those the JAX package refuses before it
    encodes) run through the JAX generate too."""
    wav = np.zeros((1, 4000), np.float32)
    if through_jax:
        import jax.numpy as jnp
        from speechmix_tpu import config as jcfg
        from speechmix_tpu import generation as j_gen
        jc = jcfg.SpeechMixConfig(
            encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
            decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
        with pytest.raises(ValueError):
            j_gen.generate({}, jc, jnp.asarray(wav), max_length=4, **kwargs)
    with pytest.raises(ValueError):
        t_gen.generate(tiny_params, _tiny_cfg(), wav, max_length=4,
                       device="cpu", **kwargs)


def test_generate_refuses_unknown_keywords(tiny_params):
    with pytest.raises(TypeError):
        t_gen.generate(tiny_params, _tiny_cfg(), np.zeros((1, 4000),
                                                          np.float32),
                       max_length=4, device="cpu", use_flash=True)


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "speechmix_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"speechmix_tpu_torch/training/trainer.py",
            "speechmix_tpu_torch/training/freezing.py",
            "speechmix_tpu_torch/ops/kernels/dropout.py",
            "speechmix_tpu_torch/convert.py",
            "speechmix_tpu_torch/models/speech_encoder.py",
            "speechmix_tpu_torch/models/speechmix.py",
            "speechmix_tpu_torch/models/seq2seq.py",
            "speechmix_tpu_torch/generation.py",
            "speechmix_tpu_torch/metrics.py",
            "speechmix_tpu_torch/data/audio.py",
            "speechmix_tpu_torch/data/collator.py",
            "speechmix_tpu_torch/data/datasets.py",
            "speechmix_tpu_torch/data/prefetch.py",
            "speechmix_tpu_torch/data/teacher.py",
            "speechmix_tpu_torch/data/tokenizer.py",
            "speechmix_tpu_torch/training/checkpoint.py",
            "speechmix_tpu_torch/utils/watchdog.py",
            "speechmix_tpu_torch/utils/quantize.py",
            "speechmix_tpu_torch/utils/platform.py",
            "speechmix_tpu_torch/models/ctc.py",
            "speechmix_tpu_torch/api.py",
            "speechmix_tpu_torch/pipeline.py",
            "speechmix_tpu_torch/train.py",
            "speechmix_tpu_torch/eval.py",
            "speechmix_tpu_torch/utils/profiling.py",
            "speechmix_tpu_torch/runtime/native.py",
            "speechmix_tpu_torch/parallel/mesh.py",
            "speechmix_tpu_torch/parallel/collectives.py",
            "speechmix_tpu_torch/parallel/launch.py",
            "speechmix_tpu_torch/ops/ring_attention.py",
            "speechmix_tpu_torch/training/sharded.py"} <= names
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "speechmix_tpu", "flax",
                               "optax"), f"{path} imports {name}"


def test_kernel_wrappers_raise_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor fails the wrapper's CUDA check."""
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.attention_fwd(meta(1, 8, 64), meta(1, 8, 64), meta(1, 8, 64),
                             None, 1, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ffn.dense_res_ln(meta(4, 8), meta(8, 8), meta(8), meta(4, 8),
                           meta(8), meta(8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ffn.ffn_res_ln(meta(4, 8), meta(8, 16), meta(16), meta(16, 8),
                         meta(8), meta(4, 8), meta(8), meta(8))


def test_new_kernel_wrappers_raise_instead_of_falling_back():
    """K4, K5 and K6 given tensors that are not on the CPU raise at their
    CUDA check and never run their plain versions."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta",
                                                       dtype=dtype)
    q, kv = meta(2, 1, 2, 64), meta(2, 8, 2, 64)
    mask = meta(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_da.decode_attention(q, kv, kv, mask, scale=0.125, num_heads=2)
    codes, scale = meta(2, 8, 2, 64, dtype=torch.int8), meta(2, 8, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_da.decode_attention(q, codes, codes, mask, scale=0.125,
                              num_heads=2, k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_bg.beam_gather(meta(2, 4, 8), meta(2, 4, 8),
                         meta(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_conv.fused_conv_layer(meta(1, 20, 16), meta(16, 16, 3), meta(16))


HEAD_DIM_RULE = "head_dim that is a multiple of 8 in \\[8, 128\\]"


@pytest.mark.parametrize("call,match", [
    # K4 takes head widths that are multiples of 8 from 8 to 128
    (lambda: t_da.decode_attention(
        _meta(2, 1, 2, 136), _meta(2, 8, 2, 136), _meta(2, 8, 2, 136),
        _meta(2, 8, dtype=torch.bool), scale=0.125, num_heads=2),
     HEAD_DIM_RULE),
    (lambda: t_da.decode_attention(
        _meta(2, 1, 2, 20), _meta(2, 8, 2, 20, dtype=torch.int8),
        _meta(2, 8, 2, 20, dtype=torch.int8), _meta(2, 8, dtype=torch.bool),
        scale=0.125, num_heads=2, k_scale=_meta(2, 8, 2, dtype=torch.float32),
        v_scale=_meta(2, 8, 2, dtype=torch.float32)), HEAD_DIM_RULE),
    (lambda: t_da.decode_attention(
        _meta(2, 1, 2, 64), _meta(2, 8, 2, 64, dtype=torch.int8),
        _meta(2, 8, 2, 64, dtype=torch.int8), _meta(2, 8, dtype=torch.bool),
        scale=0.125, num_heads=2), "k_scale and v_scale"),
    # K6 takes C <= 1024 in both dtypes
    (lambda: t_conv.fused_conv_layer(_meta(1, 20, 1536),
                                     _meta(1536, 1536, 3)),
     "supports C <= 1024"),
    (lambda: t_conv.fused_conv_layer(
        _meta(1, 20, 2048, dtype=torch.float32),
        _meta(2048, 2048, 2, dtype=torch.float32)), "supports C <= 1024"),
])
def test_new_kernel_wrappers_refuse_unbuilt_cases(call, match):
    """Shapes and types K4 and K6 have no kernel for raise for a tensor
    that is not on the CPU."""
    with pytest.raises(ValueError, match=match):
        call()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def _ffn_args(h, f):
    vec = lambda n: _meta(n, dtype=torch.float32)
    return (_meta(4, h), _meta(h, f), vec(f), _meta(f, h), vec(h),
            _meta(4, h), vec(h), vec(h))


@pytest.mark.parametrize("call,match", [
    # K2 in bf16 takes Din and H multiples of 128, as the TPU gate
    (lambda: t_ffn.dense_res_ln(
        _meta(4, 192), _meta(192, 192), _meta(192, dtype=torch.float32),
        _meta(4, 192), _meta(192, dtype=torch.float32),
        _meta(192, dtype=torch.float32)), "bfloat16 supports H"),
    # the bf16 passes of K3 take H and F multiples of 128, as the TPU gate
    (lambda: t_ffn.ffn_res_ln(*_ffn_args(192, 768)), "bfloat16 supports H"),
    (lambda: t_ffn.ffn_res_ln(*_ffn_args(768, 3000)), "bfloat16 supports H"),
    (lambda: t_ffn.ffn_res_ln(*_ffn_args(768, 3072), act="tanh"),
     "unsupported activation"),
])
def test_kernel_wrappers_refuse_unbuilt_cases(call, match):
    """bfloat16 widths without a tensor-core kernel, and activations the
    kernel lacks, raise instead of taking another path."""
    with pytest.raises(ValueError, match=match):
        call()


def test_kernel_launch_without_toolkit_raises(monkeypatch, tmp_path):
    """With no nvcc the first launch raises; nothing is counted."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda _: False)
    kernel = t_attn.KERNEL
    monkeypatch.setattr(kernel, "_fn", None)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.launch(*([0] * 14))
    assert kernel.launches == before


def test_train_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    tc = t_trainer.TrainConfig(dropout=False, optimizer="adamw")
    params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_trainer.make_train_step(cfg, tc, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_trainer.create_train_state(torch.Generator().manual_seed(0), cfg,
                                     tc)
    step = t_trainer.make_train_step(cfg, tc, params, device="cpu")
    assert callable(step)


def test_training_kernel_wrappers_raise_instead_of_falling_back():
    """K7, K8 (both entries) and K9 given tensors that are not on the CPU
    raise at their CUDA check and never run their plain versions."""
    f32 = lambda *s: _meta(*s, dtype=torch.float32)
    slab, lse = f32(1, 8, 64), f32(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.attention_bwd(slab, slab, slab, None, slab, lse, slab, 1,
                             0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_attn.attention_fwd(slab, slab, slab, None, 1, 0.125,
                             return_lse=True)
    x, w1, b1, w2, b2 = f32(4, 8), f32(8, 16), f32(16), f32(16, 8), f32(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ffn.ffn_fused(x, w1, b1, w2, b2)
    for entry in (t_ffn.ffn_bwd, t_ffn.ffn_bwd_dx, t_ffn.ffn_bwd_dw):
        with pytest.raises(ValueError, match="CUDA tensor"):
            entry(x, x, w1, b1, w2)


@pytest.mark.parametrize("call,match", [
    # K1 / K7 take head widths that are multiples of 8 from 8 to 128
    (lambda: t_attn.attention_bwd(
        _meta(1, 8, 136), _meta(1, 8, 136), _meta(1, 8, 136), None,
        _meta(1, 8, 136), _meta(1, 1, 8, dtype=torch.float32),
        _meta(1, 8, 136), 1, 0.125), HEAD_DIM_RULE),
    (lambda: t_attn.attention_fwd(
        _meta(1, 8, 40), _meta(1, 8, 40), _meta(1, 8, 40), None, 2, 0.125),
     HEAD_DIM_RULE),
    # the f32 FFN and epilogue entries take H <= 2048
    (lambda: t_ffn.ffn_fused(*(a.float() for a in _ffn_args(2176, 128)[:5])),
     "supports H <= 2048"),
    (lambda: t_ffn.dense_res_ln(
        _meta(4, 2176, dtype=torch.float32),
        _meta(2176, 2176, dtype=torch.float32),
        _meta(2176, dtype=torch.float32), _meta(4, 2176, dtype=torch.float32),
        _meta(2176, dtype=torch.float32), _meta(2176, dtype=torch.float32)),
     "supports H <= 2048"),
    (lambda: t_ffn.ffn_bwd_dx(
        *(a.float() for a in (_meta(4, 2176), _meta(4, 2176),
                              _meta(2176, 128), _meta(128),
                              _meta(128, 2176)))), "supports H <= 2048"),
    (lambda: t_ffn.ffn_fused(*_ffn_args(192, 768)[:5]),
     "bfloat16 supports H"),
    (lambda: t_ffn.ffn_bwd(_meta(4, 768), _meta(4, 768), _meta(768, 3000),
                           _meta(3000, dtype=torch.float32),
                           _meta(3000, 768)), "bfloat16 supports H"),
    (lambda: t_ffn.ffn_bwd_dw(
        _meta(4, 64, dtype=torch.float32), _meta(4, 64, dtype=torch.float32),
        _meta(64, 40, dtype=torch.float32), _meta(40, dtype=torch.float32),
        _meta(40, 64, dtype=torch.float32)), "F a multiple of 16"),
    (lambda: t_ffn.ffn_bwd_dx(*_ffn_args(768, 3072)[:1],
                              *_ffn_args(768, 3072)[:1],
                              *_ffn_args(768, 3072)[1:4], act="tanh"),
     "unsupported activation"),
])
def test_training_kernel_wrappers_refuse_unbuilt_cases(call, match):
    """Head dims, widths and activations K7, K8 and K9 have no kernel for
    raise for a tensor that is not on the CPU."""
    with pytest.raises(ValueError, match=match):
        call()


def test_wrappers_outside_the_widths_raise_and_never_run_plain(monkeypatch):
    """A tensor off the CPU (here a meta tensor, which takes the CUDA
    branch as a CUDA tensor does) at a width outside the kernels' limits
    raises the width's error; the plain versions are never called."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a plain version ran for a tensor off the CPU")
    for mod, name in ((t_attn, "attention_fwd_plain"),
                      (t_attn, "attention_bwd_plain"),
                      (t_da, "decode_attention_plain"),
                      (t_ffn, "ffn_fused_plain"), (t_ffn, "ffn_bwd_dx_plain"),
                      (t_conv, "fused_conv_layer_plain")):
        monkeypatch.setattr(mod, name, forbidden)
    slab = _meta(2, 8, 4 * 136)
    with pytest.raises(ValueError, match=HEAD_DIM_RULE):
        t_attn.attention_fwd(slab, slab, slab, None, 4, 0.125)
    with pytest.raises(ValueError, match=HEAD_DIM_RULE):
        t_attn.attention_dropout_fwd(slab, slab, slab, None, 4, 0.125, False,
                                     t_drop.DropoutKey.from_seed(0), 0.1)
    q, kv = _meta(2, 1, 4, 20), _meta(2, 8, 4, 20)
    with pytest.raises(ValueError, match=HEAD_DIM_RULE):
        t_da.decode_attention(q, kv, kv, _meta(2, 8, dtype=torch.bool),
                              scale=0.125, num_heads=4)
    f32 = lambda *s: _meta(*s, dtype=torch.float32)
    with pytest.raises(ValueError, match="supports H <= 2048"):
        t_ffn.ffn_fused(f32(4, 2176), f32(2176, 128), f32(128),
                        f32(128, 2176), f32(2176))
    with pytest.raises(ValueError, match="supports C <= 1024"):
        t_conv.fused_conv_layer(_meta(1, 20, 1536), _meta(1536, 1536, 2))


def test_loop_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Trainer, the teacher and the prefetcher resolve device=None to CUDA
    and raise without it; with device="cpu" they run."""
    from speechmix_tpu_torch.data import prefetch, teacher, tokenizer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    tc = t_trainer.TrainConfig(output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_trainer.Trainer(cfg, tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_trainer.make_eval_step(cfg, tc)
    assert t_trainer.Trainer(cfg, tc, device="cpu").device.type == "cpu"

    params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    tok = tokenizer.ByteTokenizer(pad_token_id=1, eos_token_id=2,
                                  bos_token_id=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teacher.create_self_decoder_inputs_batched(
            params["nlp"], cfg.decoder, tok, ["hi"], max_length=2,
            batch_size=1)
    pairs = teacher.create_self_decoder_inputs_batched(
        params["nlp"], cfg.decoder, tok, ["hi"], max_length=2, batch_size=1,
        device="cpu")
    assert len(pairs) == 1 and pairs[0][1][-1] == 2

    batches = [{"x": np.zeros(3, np.float32)}]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(prefetch.prefetch_to_device(iter(batches)))
    out = next(prefetch.prefetch_to_device(iter(batches), "cpu"))
    assert out["x"].device.type == "cpu"
