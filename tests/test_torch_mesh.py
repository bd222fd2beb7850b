"""The port's mesh (``parallel.mesh``): its sharding plan against the JAX
package's, leaf for leaf; make_mesh's shapes, coordinates, groups and
assertions; the per-host helpers; ZeRO-1 ownership; and dropout under a
mesh.

The plan: ``param_sharding`` (in the JAX layout) equals the JAX package's
``param_sharding`` PartitionSpecs on the same configuration for the
flagship (wav2vec2-base + bart-base), the large pair (wav2vec2-large +
bart-large), t5-small and byt5-small at n_model 2 and 4, except the
leaves the port keeps whole because their block's heads do not divide
(byt5-small's 6 heads at n_model 4: every q / k / v / out_proj kernel of
its text stacks, listed here); ``opt_state_sharding`` equals the JAX
package's on AdamW's and Adafactor's states.  Trees are shapes only
(meta tensors on the port's side, eval_shape on the JAX side).  int8
weights: the JAX package's param_sharding raises IndexError on a tree
with stacked int8 scales (its substring rule shifts a stacked scale's
spec past its rank); the port shards each kernel_q as its float kernel
and keeps the scales whole.

Dropout (4 gloo processes, (2, 2, 1), two dropout-on f32 steps with
LayerDrop at 0.5, run twice): the two runs are bit-identical, the leaves a
model group holds whole stay bit-equal across it, LayerDrop skips the same
layers on every rank, and data ranks given the same rows draw different
masks (their logits differ) while model ranks do not.  Remat at (1, 2, 2):
the gradients equal the step's without remat, bit for bit.  A gated-GELU
T5 pair at (1, 2, 1): its gradient tree equals one card's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.parallel import mesh as j_mesh
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch.models import init as t_init
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.parallel import launch
from speechmix_tpu_torch.parallel import mesh as t_mesh
from speechmix_tpu_torch.training import trainer as t_trainer
from speechmix_tpu_torch.utils import quantize as t_quant
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_worker

PAIRS = {
    "flagship": ("wav2vec2-base", "bart-base"),
    "large": ("wav2vec2-large", "bart-large"),
    "t5-small": ("wav2vec2-base", "t5-small"),
    "byt5-small": ("wav2vec2-base", "byt5-small"),
}


def _cfgs(pair):
    speech, nlp = PAIRS[pair]
    return tuple(m.SpeechMixConfig(encoder=m.SPEECH_ENCODER_PRESETS[speech],
                                   decoder=m.SEQ2SEQ_PRESETS[nlp],
                                   down_scale=2) for m in (jcfg, tcfg))


@pytest.fixture
def meta_init(monkeypatch):
    """The port's initialisers making meta tensors (shapes only)."""
    monkeypatch.setattr(t_init, "normal", lambda gen, device, shape, std,
                        dtype: torch.empty(shape, dtype=dtype,
                                           device="meta"))

    def build(tc):
        return t_smx.init_speechmix(tc, torch.Generator(), "meta")
    return build


def _jax_specs(tree, n_model):
    mesh = j_mesh.make_mesh(n_data=8 // n_model, n_model=n_model)
    flat = jax.tree_util.tree_flatten_with_path(
        j_mesh.param_sharding(mesh, tree))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(s.spec) for kp, s in flat}


def _strip(spec):
    """A spec without trailing Nones (JAX writes P() for replicated)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


EXPECTED_WHOLE = {
    ("byt5-small", 4): sorted(
        f"nlp/{stack}/layers/{attn}/{proj}/kernel"
        for stack, attns in (("encoder", ("self_attn",)),
                             ("decoder", ("self_attn", "encoder_attn")))
        for attn in attns
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj")),
}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_param_plan_matches_jax(meta_init, pair, n_model):
    jc, tc = _cfgs(pair)
    shapes = jax.eval_shape(lambda k: j_smx.init_speechmix(k, jc),
                            jax.random.PRNGKey(0))
    want = _jax_specs(shapes, n_model)
    params = meta_init(tc)
    mesh = t_mesh.Mesh(8 // n_model, n_model, 1)
    port = t_mesh.jax_param_specs(mesh, params, tc)
    as_jax = t_mesh.jax_param_specs(mesh, params, tc, port_rule=False)
    assert port.keys() == want.keys()
    for path, spec in want.items():
        assert _strip(as_jax[path]) == _strip(spec), path
    whole = t_mesh.heads_replicated(mesh, params, tc)
    assert sorted(whole) == EXPECTED_WHOLE.get((pair, n_model), []), whole
    for path in whole:
        assert port[path] == ()
    # the port-shaped plan is the JAX-layout plan per layer tensor
    plan = t_mesh.param_sharding(mesh, params, tc)
    q = plan["speech_encoder"]["layers"][0]["attention"]["q_proj"]
    assert q["kernel"] == t_mesh.P(None, "model") and q["bias"] == ()
    fc2 = plan["nlp"]["decoder"]["layers"][-1]["fc2"]["kernel"]
    assert fc2 == t_mesh.P("model", None)
    assert plan["speech_encoder"]["pos_conv"]["kernel"] == ()


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_plan_matches_jax(meta_init, optimizer):
    jc, tc = _cfgs("flagship")
    j_tc = j_trainer.TrainConfig(optimizer=optimizer)
    shapes = jax.eval_shape(lambda k: j_smx.init_speechmix(k, jc),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(j_trainer.make_optimizer(j_tc).init, shapes)
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)
    flat = jax.tree_util.tree_flatten_with_path(
        j_mesh.opt_state_sharding(mesh, opt))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) if not hasattr(k, "name") else "." + k.name
        for k in kp): tuple(s.spec) for kp, s in flat}
    params = meta_init(tc)
    state = t_trainer.make_optimizer(
        t_trainer.TrainConfig(optimizer=optimizer)).init(params)
    got = t_mesh.opt_state_sharding(t_mesh.Mesh(4, 2, 1), state)
    assert {k: _strip(v) for k, v in got.items()} == \
        {k: _strip(v) for k, v in want.items()}


def test_int8_plan(meta_init):
    jc, tc = _cfgs("flagship")
    shapes = jax.eval_shape(lambda k: j_smx.init_speechmix(k, jc),
                            jax.random.PRNGKey(0))
    from speechmix_tpu.utils.quantize import quantize_weights
    with pytest.raises(IndexError):
        _jax_specs(jax.eval_shape(quantize_weights, shapes), 2)
    float_plan = _jax_specs(shapes, 2)
    mesh = t_mesh.Mesh(4, 2, 1)
    port = t_mesh.jax_param_specs(mesh, t_quant.quantize_weights(
        meta_init(tc)), tc)
    kernels = [p for p in port if p.endswith("/kernel_q")]
    assert kernels and any(port[p] for p in kernels)
    for path in kernels:
        assert _strip(port[path]) == _strip(float_plan[path[:-2]]), path
        assert port[path[:-2] + "_scale"] == ()


def test_make_mesh_without_a_process_group():
    mesh = t_mesh.make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.n_seq) == (1, 1, 1)
    assert mesh.coords == {"data": 0, "model": 0, "seq": 0}
    assert mesh.group("data") is None and not mesh.distributed
    with pytest.raises(AssertionError, match="exceeds the device count"):
        t_mesh.make_mesh(n_model=2, device="cpu")
    with pytest.raises(AssertionError, match="needs 2 devices, have 1"):
        t_mesh.make_mesh(n_data=2, device="cpu")


def test_per_host_helpers():
    """per_host_batch_slice keyed on the data rank; shard_examples_per_host
    against the JAX package's at simulated process counts; the
    micro-batch-aware row index and ZeRO-1's ownership."""
    for n_data, n_model in ((4, 1), (2, 2), (1, 4)):
        for rank in range(n_data * n_model):
            mesh = t_mesh.Mesh(n_data, n_model, 1, rank=rank)
            per = 16 // n_data
            assert t_mesh.per_host_batch_slice(16, mesh) == slice(
                mesh.data_rank * per, (mesh.data_rank + 1) * per)
    ex = list(range(11))
    for n in (1, 2, 3, 4):
        for i in range(n):
            assert t_mesh.shard_examples_per_host(ex, i, n) == \
                j_mesh.shard_examples_per_host(ex, i, n)
    assert list(t_mesh.local_batch_index(8, 2, 1, accum=2)) == [2, 3, 6, 7]
    assert list(t_mesh.local_batch_index(8, 2, 0)) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        t_mesh.local_batch_index(6, 2, 0, accum=2)
    sizes = [100, 60, 50, 40, 10, 5]
    owners = t_mesh.zero1_owners(sizes, 2)
    loads = [sum(s for s, o in zip(sizes, owners) if o == r)
             for r in range(2)]
    assert max(loads) <= sum(sizes) / 2 + max(sizes)
    assert owners == t_mesh.zero1_owners(sizes, 2)


SHAPES = [(2, 2, 1), (1, 2, 2), (4, 1, 1), (2, 1, 1)]


def _tree4():
    jc = jcfg.SpeechMixConfig(
        encoder=dataclasses.replace(jcfg.SPEECH_ENCODER_PRESETS[
            "tiny-speech"], num_layers=4),
        decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    return jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))


def _dropout_batch():
    rng = np.random.RandomState(0)
    wav = (rng.randn(8, 6000) * 0.1).astype(np.float32)
    labels = rng.randint(3, 384, size=(8, 8)).astype(np.int32)
    return {"input_values": wav, "lengths": np.full(8, 6000, np.int32),
            "labels": labels}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tc_kw = dict(learning_rate=1e-3, warmup_steps=0, dropout=True,
                 optimizer="adamw", grad_accum=2, fixed_nlp=False, seed=3)
    return launch.spawn(
        torch_mesh_worker.mesh_and_dropout, 4,
        (SHAPES, _tree4(), _dropout_batch(), tc_kw, _gated_t5_tree()),
        init_method=launch.file_store(tmp_path_factory.mktemp("mesh")),
        timeout_s=240)


def test_make_mesh_layout_and_groups(four_ranks):
    """Coordinates data-major as np.arange(world).reshape(shape); each
    axis group holds the ranks along that axis (an all-reduce of the ranks
    sums them); ranks beyond the mesh get None."""
    for i, shape in enumerate(SHAPES):
        grid = np.arange(int(np.prod(shape))).reshape(shape)
        for rank, (meshes, *_) in enumerate(four_ranks):
            got = meshes[i]
            if rank >= grid.size:
                assert got is None
                continue
            d, m, s = (int(x) for x in np.argwhere(grid == rank)[0])
            assert got["coords"] == (d, m, s)
            lines = {"data": grid[:, m, s], "model": grid[d, :, s],
                     "seq": grid[d, m, :]}
            for axis, line in lines.items():
                assert got["ranks"][axis] == list(line)
                assert got["sum"][axis] == float(line.sum())


def test_dropout_under_a_mesh(four_ranks):
    results = [drop for _, drop, *_ in four_ranks]
    for r in results:   # two runs from one state: bit-identical
        a, b = r["runs"]
        assert a["losses"] == b["losses"]
        assert a["replicated"] == b["replicated"]
    first = results[0]["runs"][0]
    for r in results[1:]:
        # LayerDrop: the same layers everywhere; the global metrics too
        assert r["runs"][0]["skipped"] == first["skipped"]
        assert r["runs"][0]["losses"] == first["losses"]
    assert any(skipped for step in first["skipped"] for skipped in step)
    by_data = {}
    for r in results:
        by_data.setdefault(r["coords"][0], []).append(r)
    for group in by_data.values():   # model replicas: the same masks
        assert group[0]["logits_sum"] == group[1]["logits_sum"]
        for path, data in group[0]["runs"][0]["replicated"].items():
            assert group[1]["runs"][0]["replicated"][path] == data, path
    # data ranks on the same rows: their own masks
    assert by_data[0][0]["logits_sum"] != by_data[1][0]["logits_sum"]


def test_remat_under_a_mesh(four_ranks):
    """Rematerialised layers run their forward again in the backward; the
    step keeps the mesh active there, so TP and the ring recompute on the
    same shares: the gradients equal the step without remat, bit for bit,
    on every rank of (1, 2, 2)."""
    assert all(r[2] for r in four_ranks)


def _gated_t5_tree():
    jc = jcfg.SpeechMixConfig(
        encoder=dataclasses.replace(jcfg.SPEECH_ENCODER_PRESETS[
            "tiny-speech"], num_layers=2),
        decoder=dataclasses.replace(jcfg.SEQ2SEQ_PRESETS["tiny-t5-bytes"],
                                    activation="gelu_gated"),
        down_scale=2)
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(1), jc))
    rng = np.random.RandomState(2)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if a.ndim >= 2 else a, tree)


def test_gated_t5_under_tensor_parallelism(four_ranks):
    """A gated-GELU T5 pair at (1, 2, 1): the gradient tree gathered over
    the model group equals the one-card step's to 1e-5 of each leaf's
    largest magnitude plus 0.1 of the tree's largest (attention key
    biases have a gradient of rounding noise), the grad norm to 1e-5,
    with the q / k / v / out_proj and fc_gate / fc1 / fc2 kernels split."""
    for r in four_ranks[:2]:
        got = r[3]
        assert got["split"] > 0
        assert got["worst"] <= 1e-5, got
        a, b = got["norm"]
        assert abs(a - b) <= 1e-5 * b, got
    assert four_ranks[2][3] is None and four_ranks[3][3] is None


def test_shard_opt_state_keeps_the_owned_leaves(meta_init):
    """ZeRO-1's share of a whole AdamW state: each data rank keeps the
    leaves zero1_owners gives it and None elsewhere; the shares cover
    every leaf once."""
    _, tc = _cfgs("flagship")
    params = meta_init(tc)
    state = t_trainer.make_optimizer(
        t_trainer.TrainConfig(optimizer="adamw")).init(params)
    leaves = [t for _, t in t_trainer.tree_paths(state["mu"])]
    owners = t_mesh.zero1_owners([t.numel() for t in leaves], 2)
    kept = []
    for rank in range(2):
        share = t_mesh.shard_opt_state(t_mesh.Mesh(2, 1, 1, rank=rank),
                                       state, owners)
        mine = [t is not None for _, t in t_trainer.tree_paths(share["mu"])]
        assert mine == [o == rank for o in owners]
        kept.append(mine)
    assert all(a != b for a, b in zip(*kept))
