"""The port's train step over a mesh against the JAX package's
``make_train_step(..., mesh=)`` at the same mesh, float32 on the CPU
(data, tensor and sequence parallelism here; ZeRO-1, the gan variant and a
T5 pair in ``test_torch_parallel_zero1.py``, which shares these helpers).

The port runs in 4 gloo processes (one spawn for every case; ranks beyond
a mesh sit it out), the JAX package on the 8 virtual CPU devices.  Tiny
configuration: tiny-speech cut to 2 layers + tiny-bart-bytes (4 heads, FFN
128: every block splits at n_model = 2), matrices redrawn at std 0.1, the
whole model trained (fixed_nlp off), dropout off, grad_accum 2 over a
global batch of 8 rows with unequal label counts, three steps with one
warmup step (the first update has rate 0, as in test_torch_train.py).  Meshes: DP
(2,1,1), TP (1,2,1), SP (1,1,2), TP x SP (1,2,2), and DP x TP with ZeRO-1
under AdamW and under Adafactor (2,2,1); the gan variant and a T5 pair
(tiny-t5-bytes) at (2,2,1).

What each case pins: the global loss denominators (a mean of local means
would differ: the rows' label counts differ), which gradients are summed
over which group, the ring's hand-written backward inside the step, TP's
column / row split with the biases' partial gradients, Adafactor's
statistics over the whole leaf under TP and ZeRO-1, and the broadcast of
updated parameters.  Tolerances are ``tests/test_torch_train.py``'s: loss
and grad norm 1e-4 relative (+1e-6), every parameter after each step 1e-4
of its largest magnitude + 2e-6; attention key biases (a gradient that is
zero in exact arithmetic) to the learning rate per step.  One more rule for
AdamW, whose update divides each element's momentum by its own scale: an
element whose two gradients nearly cancel in the momentum has an update
decided by rounding, and the one-card port differs from the JAX step there
as much (decoder self-attention q_proj element (1, 37, 24) of this tree,
1.2e-4 after step 2); at most 0.1% of a leaf's elements (at least one)
may exceed the limit, each by no more than the learning rate per step
taken.  A fault of the mesh (a missing or doubled sum, a wrong share)
moves whole rows or leaves, which this rule does not admit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.parallel import mesh as j_mesh
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch.parallel import launch
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_worker

LR = 1e-3
STEPS = 3
BASE = dict(learning_rate=LR, warmup_steps=1, lr_schedule="linear", max_steps=10,
            max_grad_norm=1.0, grad_accum=2, dropout=False,
            fixed_speech=False, fixed_nlp=False)

# name: (config spec, mesh, optimizer, zero1)
CASES = {
    "dp (2,1,1)": (("tiny-speech", "tiny-bart-bytes", 2, 2, "eed"),
                   (2, 1, 1), "adamw", False),
    "tp (1,2,1)": (("tiny-speech", "tiny-bart-bytes", 2, 2, "eed"),
                   (1, 2, 1), "adamw", False),
    "sp (1,1,2)": (("tiny-speech", "tiny-bart-bytes", 2, 2, "eed"),
                   (1, 1, 2), "adamw", False),
    "tp x sp (1,2,2)": (("tiny-speech", "tiny-bart-bytes", 2, 2, "eed"),
                        (1, 2, 2), "adamw", False),
}


def _jax_cfg(spec):
    speech, nlp, layers, down, variant = spec
    enc = dataclasses.replace(jcfg.SPEECH_ENCODER_PRESETS[speech],
                              num_layers=layers)
    return jcfg.SpeechMixConfig(encoder=enc, decoder=jcfg.SEQ2SEQ_PRESETS[nlp],
                                down_scale=down, variant=variant)


def _tree(jc, seed=1):
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim >= 2 and "layer_norm" not in name:
            scale = 1e-3 if "discriminator" in name else 0.1
            return (rng.randn(*a.shape) * scale).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _batch(rows=8, label_len=10, seed=0, t5=False):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(rows, 6000) * 0.1).astype(np.float32)
    lens = np.array([6000, 4700, 6000, 5200, 3900, 6000, 5500, 4400][:rows],
                    np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    labels = rng.randint(3, 384, size=(rows, label_len)).astype(np.int32)
    # unequal label counts per row, so per-rank token counts differ
    for i, n in enumerate([10, 3, 7, 10, 2, 9, 5, 8][:rows]):
        labels[i, n:] = -100
    return {"input_values": wav, "lengths": lens, "labels": labels}


def _case_inputs(name, cases=None):
    spec, mesh, opt, zero1 = (cases or CASES)[name]
    jc = _jax_cfg(spec)
    return jc, _tree(jc), _batch(), dict(BASE, optimizer=opt, zero1=zero1,
                                         model_parallel=mesh[1],
                                         sequence_parallel=mesh[2])


def run_port(cases, tmp_dir):
    """{name: [each rank's result]} of the cases, one spawn of 4 ranks."""
    specs = []
    for name, (spec, mesh, _, _) in cases.items():
        _, tree, batch, tc = _case_inputs(name, cases)
        specs.append({"config": spec, "mesh": mesh, "tc": tc, "tree": tree,
                      "batch": batch, "steps": STEPS})
    per_rank = launch.spawn(torch_mesh_worker.train_cases, 4, (specs,),
                            init_method=launch.file_store(tmp_dir),
                            timeout_s=300)
    return {name: [r[i] for r in per_rank if r[i] is not None]
            for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return run_port(CASES, tmp_path_factory.mktemp("train"))


_JAX_RUNS = {}


def _jax_steps(name, cases=None, mesh_shape=None, zero1=None):
    """The JAX package's steps of case `name` at its mesh (or at
    `mesh_shape`, with `zero1` overridden), cached."""
    cases = cases or CASES
    spec, shape, opt, z = cases[name]
    shape = mesh_shape or shape
    z = z if zero1 is None else zero1
    key = (spec, shape, opt, z)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(name, cases, shape, z)
    return _JAX_RUNS[key]


def _jax_run(name, cases, shape, zero1):
    jc, tree, batch, kw = _case_inputs(name, cases)
    kw = dict(kw, zero1=zero1, model_parallel=shape[1],
              sequence_parallel=shape[2])
    mesh = j_mesh.make_mesh(*shape)
    j_tc = j_trainer.TrainConfig(use_flash=False, **kw)
    params = j_mesh.shard_params(mesh, jax.tree_util.tree_map(jnp.asarray,
                                                              tree))
    opt = j_trainer.make_optimizer(j_tc).init(params)
    if kw["zero1"]:
        opt = j_mesh.shard_opt_state(mesh, opt)
    state = j_trainer.TrainState(params, opt, jnp.zeros((), jnp.int32))
    step = j_trainer.make_train_step(jc, j_tc, params, mesh=mesh)
    placed = j_mesh.shard_batch(mesh, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    out = []
    for _ in range(STEPS):
        state, metrics = step(state, placed, jnp.float32(1.0))
        # copies: the next step donates (and overwrites) these buffers
        flat = {jax.tree_util.keystr(kp): np.array(leaf) for kp, leaf in
                jax.tree_util.tree_flatten_with_path(state.params)[0]}
        out.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                    flat))
    return out


def _keystr(path):
    """jax.tree_util.keystr of a "/"-joined path (list indices bare)."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in path.split("/"))


def check_against_jax(ranks, ref, loss_ref=None):
    """The ranks' metrics (equal on every rank) and rank 0's parameters
    after each step against the JAX steps `ref` (the loss also against
    `loss_ref`'s when given), at the limits above."""
    for r in ranks[1:]:   # the metrics are the global batch's everywhere
        assert r["loss"] == ranks[0]["loss"]
        assert r["grad_norm"] == ranks[0]["grad_norm"]
    got = ranks[0]
    for step, (loss, norm, params) in enumerate(ref):
        checks = [("loss", got["loss"][step], loss),
                  ("grad_norm", got["grad_norm"][step], norm)]
        if loss_ref is not None:
            checks.append(("loss", got["loss"][step], loss_ref[step][0]))
        for what, a, b in checks:
            assert abs(a - b) <= 1e-4 * abs(b) + 1e-6, (step, what, a, b)
        port = {_keystr(p): a for p, a in got["params"][step].items()}
        assert port.keys() == params.keys()
        for path, want in params.items():
            assert port[path].shape == want.shape, path
            if "k_proj" in path and "bias" in path:
                diff = (port[path] - want).astype(np.float64)
                rms = np.sqrt(np.mean(diff ** 2))
                assert rms <= 2 * LR * (step + 1), f"{path}: rms {rms}"
                continue
            limit = 1e-4 * np.abs(want).max() + 2e-6
            err = np.abs(port[path] - want)
            over = err > limit
            assert over.sum() <= max(1, want.size // 1000), \
                f"step {step + 1} {path}: {over.sum()} elements over {limit}"
            assert err.max() <= max(limit, (step + 1) * LR), \
                f"step {step + 1} {path}: {err.max()} > {limit}"


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_jax_mesh_step(port_runs, name):
    """At (1, 2, 2) the JAX package's mesh step computes a grad norm that
    differs from its own one-card and (1, 2, 1) steps' (3.3237 against
    2.9051 at step 1, with equal losses), and clips by it, so its later
    parameters differ too: there the port is held to the JAX (1, 2, 1)
    step (the same function), and its losses also to the (1, 2, 2)
    step's."""
    if CASES[name][1] == (1, 2, 2):
        check_against_jax(port_runs[name],
                          _jax_steps(name, mesh_shape=(1, 2, 1)),
                          loss_ref=_jax_steps(name))
    else:
        check_against_jax(port_runs[name], _jax_steps(name))


def check_replicas_equal(ranks):
    """Every leaf a rank holds whole is bit-equal across its model group
    (and its data / seq replicas) after the steps."""
    first = ranks[0]["replicated"]
    for r in ranks[1:]:
        assert r["replicated"].keys() == first.keys()
        for path, data in first.items():
            assert r["replicated"][path] == data, (r["coords"], path)


@pytest.mark.parametrize("name", list(CASES))
def test_model_group_replicas_stay_equal(port_runs, name):
    check_replicas_equal(port_runs[name])
