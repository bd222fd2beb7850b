"""remat in the port (``cfg.remat`` of the speech encoder and the seq2seq
config, read by ``ops.layers.remat`` at the speech-encoder loop, the text
encoder loop and the teacher-forced decoder loop), float32 on the CPU.

With remat on, a layer's forward runs once more in the backward pass under
torch.utils.checkpoint.  The recompute draws the same dropout masks (Philox
words of the layer's key) and touches no torch RNG, so the loss and every
gradient are bit-identical to remat off, with and without dropout, on the
plain chain and through the kernels' autograd functions (plain versions on
the CPU); and they match jax.grad of the JAX package's remat forward within
test_torch_train.py's limits (1e-4 of a leaf's largest magnitude + 1e-7).
The forward keeps fewer saved bytes; generate never rematerialises.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_train import _assert_trees_close, _batch, _j, _t_batch, _tree
from torch_threads import one_torch_thread  # noqa: F401

# the flagship's SpecAugment and LayerDrop, drawn before the layer loop
FLAGSHIP_SPEECH = dict(apply_spec_augment=True, layerdrop=0.1)


def _cfg(mod, remat, decoder="tiny-bart-bytes", **speech):
    enc = dataclasses.replace(mod.SPEECH_ENCODER_PRESETS["tiny-speech"],
                              num_layers=2, remat=remat, **speech)
    dec = dataclasses.replace(mod.SEQ2SEQ_PRESETS[decoder], remat=remat)
    return mod.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2)


def _loss_and_grads(params, cfg, tb, key):
    leaves = t_trainer.tree_map(
        lambda p: p.detach().clone().requires_grad_(), params)
    out = t_smx.speechmix_forward(leaves, cfg, tb["input_values"],
                                  tb["lengths"], labels=tb["labels"],
                                  dropout_rng=key)
    flat = [leaf for _, leaf in t_trainer.tree_paths(leaves)]
    grads = torch.autograd.grad(out["loss"], flat, allow_unused=True)
    return (out["loss"].detach(), out["layers_skipped"],
            [None if g is None else g.detach() for g in grads])


@pytest.mark.parametrize("decoder", ["tiny-bart-bytes", "tiny-t5-bytes"])
@pytest.mark.parametrize("min_rows", [1024, 1],
                         ids=["plain-chain", "kernel-functions"])
@pytest.mark.parametrize("dropout", [False, True],
                         ids=["deterministic", "dropout"])
def test_remat_loss_and_gradients_bit_identical(dropout, min_rows, decoder,
                                                monkeypatch):
    """remat on against remat off: the same loss and gradient bits, and
    each speech, text-encoder and decoder layer run twice with remat (the
    recompute), once without; the global torch RNG untouched."""
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
    speech = FLAGSHIP_SPEECH if dropout else {}
    key = DropoutKey.from_seed(7) if dropout else None
    tb = _t_batch(_batch())
    calls = {}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(t_se, "_encoder_layer",
                        counted("speech", t_se._encoder_layer))
    monkeypatch.setattr(t_s2s, "_encoder_block",
                        counted("text", t_s2s._encoder_block))
    monkeypatch.setattr(t_s2s, "_decoder_block",
                        counted("decoder", t_s2s._decoder_block))
    results = {}
    for remat in (False, True):
        cfg = _cfg(tcfg, remat, decoder, **speech)
        params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        calls.clear()
        rng = torch.get_rng_state()
        results[remat] = _loss_and_grads(params, cfg, tb, key)
        assert torch.equal(torch.get_rng_state(), rng)
        kept = 2 - len(results[remat][1])
        assert calls == {"speech": kept * (1 + remat),
                         "text": 2 * (1 + remat),
                         "decoder": 2 * (1 + remat)}, (remat, calls)
    (loss0, skip0, grads0), (loss1, skip1, grads1) = (results[False],
                                                      results[True])
    assert torch.equal(loss0, loss1) and skip0 == skip1
    assert len(grads0) == len(grads1)
    for g0, g1 in zip(grads0, grads1):
        assert (g0 is None) == (g1 is None)
        if g0 is not None:
            assert torch.equal(g0, g1)


@functools.lru_cache(maxsize=None)
def _jax_remat_grad_tree():
    jc = _cfg(jcfg, True)

    def loss_fn(p, b):
        return j_smx.speechmix_forward(
            p, jc, b["input_values"], b["lengths"],
            labels=b["labels"])["loss"]
    return jax.jit(jax.grad(loss_fn))(_j(_tree(jc)), _j(_batch()))


@pytest.mark.parametrize("min_rows", [1024, 1],
                         ids=["plain-chain", "kernel-functions"])
def test_remat_gradients_match_jax_remat(min_rows, monkeypatch):
    """The port's gradient tree with remat on against jax.grad through the
    JAX package's jax.checkpoint'ed layers, leaf by leaf."""
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
    jc, tc = _cfg(jcfg, True), _cfg(tcfg, True)
    params = convert.params_from_jax(_tree(jc), tc)
    leaves = t_trainer.tree_map(lambda p: p.requires_grad_(), params)
    tb = _t_batch(_batch())
    loss = t_smx.speechmix_forward(leaves, tc, tb["input_values"],
                                   tb["lengths"], labels=tb["labels"])["loss"]
    flat = [leaf for _, leaf in t_trainer.tree_paths(leaves)]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grad_tree = t_trainer.tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(grads)), leaves)
    _assert_trees_close(grad_tree, _jax_remat_grad_tree(), rel=1e-4,
                        atol=1e-7)


def _saved_bytes(cfg, params, tb, key):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    leaves = t_trainer.tree_map(
        lambda p: p.detach().clone().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        t_smx.speechmix_forward(leaves, cfg, tb["input_values"],
                                tb["lengths"], labels=tb["labels"],
                                dropout_rng=key)
    return total[0]


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["deterministic", "dropout"])
def test_remat_saves_fewer_bytes(dropout):
    """The tensors autograd keeps for the backward, counted by a
    saved_tensors_hooks around the forward: with remat only what lies
    outside the layers (and the checkpoints' own inputs) is kept."""
    key = DropoutKey.from_seed(3) if dropout else None
    tb = _t_batch(_batch())
    saved = {}
    for remat in (False, True):
        cfg = _cfg(tcfg, remat)
        params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        saved[remat] = _saved_bytes(cfg, params, tb, key)
    assert 0 < saved[True] < 0.5 * saved[False], saved


@pytest.mark.parametrize("kwargs", [dict(), dict(num_beams=2)],
                         ids=["greedy", "beam-2"])
def test_generate_unchanged_under_remat(kwargs, monkeypatch):
    """generate runs without autograd: remat never checkpoints there, and
    the tokens and scores are those of remat off."""
    import torch.utils.checkpoint as ckpt

    def refuse(*a, **kw):
        raise AssertionError("generate reached torch.utils.checkpoint")
    wav = np.random.RandomState(0).randn(2, 8000).astype(np.float32) * 0.1
    out = {}
    for remat in (False, True):
        cfg = _cfg(tcfg, remat)
        params = t_smx.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
        if remat:
            monkeypatch.setattr(ckpt, "checkpoint", refuse)
        out[remat] = t_gen.generate(params, cfg, wav, max_length=8,
                                    device="cpu", **kwargs)
    for a, b in zip(out[False], out[True]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
