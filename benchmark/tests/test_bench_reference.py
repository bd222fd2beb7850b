"""The plain reference against the port's plain path (the CPU runs the
kernels' plain versions) at tiny presets: greedy tokens through the cache
against the reference's full decoder forward, and three training steps
with dropout, SpecAugment and LayerDrop (loss, first gradient norms from
the optimizer's state, the change of every leaf)."""


import pytest
import torch

import bench_tiny
from benchmark import traffic, weights
from benchmark.reference import model
from benchmark.reference import train as ref_train


def _batch(cfg, seed, b=4, samples=6400):
    g = torch.Generator().manual_seed(seed)
    padded = cfg.encoder.aligned_samples(samples)
    lengths = torch.linspace(samples // 2, samples, b).long()
    wav = torch.randn(b, padded, generator=g) * 0.1
    wav = wav * (torch.arange(padded)[None] < lengths[:, None])
    labels = torch.randint(4, 384, (b, 12), generator=g)
    labels[torch.arange(12)[None] >= (6 + torch.arange(b) % 6)[:, None]] = \
        -100
    return {"input_values": wav, "lengths": lengths, "labels": labels}


@pytest.mark.parametrize("preln", [False, True])
def test_weights_have_the_port_layout(preln):
    from speechmix_tpu_torch.models import speechmix
    from speechmix_tpu_torch.training.freezing import tree_paths
    cfg, f = bench_tiny.config(preln)
    ours = weights.make(f["speechmix"], 3, "cpu")
    port = speechmix.init_speechmix(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    shapes = lambda t: [(p, tuple(v.shape), v.dtype) for p, v in
                        tree_paths(t)]
    assert shapes(ours) == shapes(port)
    again = weights.make(f["speechmix"], 3, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_paths(ours), tree_paths(again)))


@pytest.mark.parametrize("preln", [False, True])
def test_no_bias_or_layer_norm_starts_at_zero_or_one(preln):
    """Biases and LayerNorm terms are drawn, so the check sees every bias
    add and LayerNorm affine term of the forward."""
    from speechmix_tpu_torch.training.freezing import tree_paths
    _, f = bench_tiny.config(preln)
    params = weights.make(f["speechmix"], 4, "cpu")
    for path, leaf in tree_paths(params):
        if path.endswith("bias") or path.endswith("scale"):
            assert leaf.std() > 0, path
            assert not torch.isin(leaf, torch.tensor([0.0, 1.0])).any(), \
                path


@pytest.mark.parametrize("preln", [False, True])
def test_greedy_tokens_are_the_reference_argmax(preln):
    from speechmix_tpu_torch import generation
    cfg, f = bench_tiny.config(preln)
    params = weights.make(f["speechmix"], 5, "cpu")
    batch = _batch(cfg, 6, b=3)
    toks, _ = generation.generate(params, cfg, batch["input_values"],
                                  batch["lengths"], max_length=8,
                                  device="cpu", output_scores=False)
    logits = model.served_logits(params, f["speechmix"],
                                 batch["input_values"], batch["lengths"],
                                 toks)
    # the served positions: up to and including the first EOS
    from benchmark.check import served_lengths
    n = served_lengths(toks, cfg.decoder.eos_token_id)
    valid = torch.arange(8)[None] < n[:, None]
    assert torch.equal(logits.argmax(-1)[valid], toks[valid])
    gap = logits.max(-1).values - logits.gather(-1, toks[..., None])[..., 0]
    assert float(gap[valid].max()) == 0.0


@pytest.mark.parametrize("preln", [False, True])
def test_train_steps_follow_the_port(preln):
    from benchmark import check, program
    cfg, f = bench_tiny.config(preln)
    mix = bench_tiny.MIXES["train_step"]
    session = program.Train(f, mix, 11, "cpu")
    readings = session.warm()
    params = weights.make(f["speechmix"], traffic.sub_seed(11, "weights"),
                          "cpu")
    ref = ref_train.run_steps(params, f["speechmix"],
                              [session.batch(i) for i in range(3)],
                              session.dropout_seed, session.recipe)
    assert readings["skipped"] == ref["skipped"]
    assert any(readings["skipped"])   # LayerDrop skipped a layer
    numbers, details = check.gaps(readings, ref)
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-5
    assert numbers["delta_gap_median"] < 1e-5
    assert numbers["delta_gap_worst"] < 1e-5
    assert numbers["layerdrop_mismatch"] == 0
    # the key projections' biases have no gradient: left out by the rule
    assert any("k_proj/bias" in n for n in details["excluded"])
    assert all("k_proj/bias" in n for n in details["excluded"])


def test_dropout_changes_the_loss():
    """The reference's masks act: another key gives another loss."""
    cfg, f = bench_tiny.config()
    params = weights.make(f["speechmix"], 2, "cpu")
    batch = _batch(cfg, 3)
    from benchmark.reference.keys import step_key
    args = (params, f["speechmix"], batch["input_values"], batch["lengths"],
            batch["labels"])
    with torch.no_grad():
        a, _ = model.forward_loss(*args, step_key(1, 0))
        b, _ = model.forward_loss(*args, step_key(1, 1))
        c, _ = model.forward_loss(*args, None)
    assert len({float(a), float(b), float(c)}) == 3


def test_masks_match_the_port_generator():
    from speechmix_tpu_torch.ops.kernels import dropout as port
    from benchmark.reference import keys
    for seed in (0, 7, 2 ** 40 + 3):
        ours = keys.Key.from_seed(seed).fold_in(5).split(3)[2]
        theirs = port.DropoutKey.from_seed(seed).fold_in(5).split(3)[2]
        assert ours.seed == theirs.seed
        for stream in (0, 1):
            assert torch.equal(
                keys.mask(ours, stream, 37, 21, 0.1, "cpu"),
                port.dropout_mask_plain(theirs, stream, 37, 21, 0.1))
    big = keys.Key.from_seed(9)
    keys._BLOCK_ELEMENTS, saved = 64, keys._BLOCK_ELEMENTS
    try:
        blocked = keys.mask(big, 0, 50, 30, 0.2, "cpu")
    finally:
        keys._BLOCK_ELEMENTS = saved
    assert torch.equal(blocked, keys.mask(big, 0, 50, 30, 0.2, "cpu"))
