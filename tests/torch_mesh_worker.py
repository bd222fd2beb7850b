"""Rank programs of the port's multi-process tests: each runs in a process
that ``speechmix_tpu_torch.parallel.launch.spawn`` started (gloo on the
CPU, one torch thread) and returns numpy results to the test.  Several
mesh shapes run in one spawn; a rank outside a shape's mesh returns None
for it.  Nothing here imports JAX."""

import numpy as np
import torch

from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops import ring_attention as ring
from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey
from speechmix_tpu_torch.parallel import collectives
from speechmix_tpu_torch.parallel import mesh as mesh_lib
from speechmix_tpu_torch.training import sharded
from speechmix_tpu_torch.training import trainer as t_trainer


def _coords(mesh):
    return (mesh.data_rank, mesh.model_rank, mesh.seq_rank)


def ring_cases(rank, cases):
    """Ring attention on this rank's rows (data), heads (model) and time
    slice (seq) of global q / k / v; the output and the gradients of
    sum(out * w) on the slices."""
    results = []
    for case in cases:
        mesh = mesh_lib.make_mesh(*case["mesh"], device="cpu")
        if mesh is None:
            results.append(None)
            continue
        b, t, h, d = case["q"].shape
        n_seq = mesh.n_seq
        rows = slice(mesh.data_rank * b // mesh.n_data,
                     (mesh.data_rank + 1) * b // mesh.n_data)
        hl = h // mesh.n_model
        heads = slice(mesh.model_rank * hl, (mesh.model_rank + 1) * hl)
        t_pad = -(-t // n_seq) * n_seq
        tl = t_pad // n_seq
        times = slice(mesh.seq_rank * tl, (mesh.seq_rank + 1) * tl)

        def local(a, with_heads=True):
            x = torch.from_numpy(np.ascontiguousarray(a[rows]))
            x = ring.pad_time(x, n_seq)[:, times]
            return x[:, :, heads].contiguous() if with_heads else x
        q, k, v = (local(case[n]).requires_grad_(True) for n in "qkv")
        mask = case.get("mask")
        mask = None if mask is None else local(mask, with_heads=False)
        if mask is None and t_pad != t:
            mask = local(np.ones((b, t), bool), with_heads=False)
        key = (DropoutKey.from_seed(case["seed"]) if case.get("rate")
               else None)
        out = ring.ring_attention(q, k, v, mask, scale=case["scale"],
                                  mesh=mesh, dropout_rate=case.get("rate", 0),
                                  dropout_key=key)
        w = local(case["w"])
        (out * w).sum().backward()
        results.append({"coords": _coords(mesh), "rows": rows,
                        "heads": heads, "times": times,
                        "out": out.detach().numpy(),
                        "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                        "dv": v.grad.numpy()})
    return results


def build_config(spec):
    """The port's SpeechMixConfig of a (speech preset, nlp preset,
    speech layers, down_scale, variant) spec."""
    import dataclasses
    speech, nlp, layers, down, variant = spec
    enc = dataclasses.replace(tcfg.SPEECH_ENCODER_PRESETS[speech],
                              num_layers=layers)
    return tcfg.SpeechMixConfig(encoder=enc,
                                decoder=tcfg.SEQ2SEQ_PRESETS[nlp],
                                down_scale=down, variant=variant)


def _jax_layout_flat(tree):
    return dict(convert.flatten_with_paths(convert.tree_to_jax_layout(tree)))


def train_cases(rank, cases):
    """Train steps of each case over its mesh from one-card starting state
    (a JAX-layout numpy tree); per step the loss and grad norm, then the
    whole parameters in the JAX layout (rank 0), each rank's optimizer
    state bytes and LayerDrop's skipped layers."""
    results = []
    for case in cases:
        mesh = mesh_lib.make_mesh(*case["mesh"], device="cpu")
        if mesh is None:
            results.append(None)
            continue
        cfg = build_config(case["config"])
        tc = t_trainer.TrainConfig(**case["tc"])
        if case.get("row_gate") is not None:
            t_layers.FUSED_MIN_ROWS = case["row_gate"]
        params = convert.params_from_jax(case["tree"], cfg)
        full = t_trainer.TrainState(
            params, t_trainer.make_optimizer(tc).init(params), 0)
        state = t_trainer.shard_train_state(full, mesh, cfg, tc)
        step_fn = t_trainer.make_train_step(cfg, tc, state.params,
                                            device="cpu", mesh=mesh)
        losses, norms, skipped, per_step = [], [], [], []
        opt = t_trainer.make_optimizer(tc)
        for _ in range(case["steps"]):
            batch = mesh_lib.local_batch(mesh, case["batch"], tc.grad_accum)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            skipped.append(metrics["layers_skipped"])
            whole = sharded.full_state(state, step_fn.layout, opt)
            if rank == 0:
                per_step.append(_jax_layout_flat(whole.params))
        # the state this rank would hold without ZeRO-1, and its largest leaf
        plain = sharded.StepLayout(mesh, cfg, state.params, tc.optimizer,
                                   False, tc.sequence_parallel > 1)
        unsharded = t_trainer.make_optimizer(tc, plain).init(state.params)
        leaf_bytes = [t.numel() * 4 for k, v in unsharded.items()
                      if k != "count" for _, t in t_trainer.tree_paths(v)]
        res = {"coords": _coords(mesh), "loss": losses, "grad_norm": norms,
               "skipped": skipped,
               "opt_bytes": sharded.opt_state_bytes(state.opt_state),
               "unsharded_opt_bytes": sharded.opt_state_bytes(unsharded),
               "max_leaf_bytes": max(leaf_bytes) * (
                   2 if tc.optimizer == "adamw" else 3),
               "params": per_step,
               "replicated": _replicated_leaves(state, step_fn.layout)}
        results.append(res)
    return results


def _replicated_leaves(state, layout):
    """{path: bytes of the leaf} of every parameter this rank holds whole
    (the leaves its model group must keep bit-equal)."""
    return {p: t.detach().numpy().tobytes()
            for p, t in t_trainer.tree_paths(state.params)
            if layout.model_dim(t) is None}


def _tiny_model(tree, down_scale=2, speech_layers=None):
    import speechmix_tpu_torch
    from speechmix_tpu_torch.models import speech_encoder as se
    model = speechmix_tpu_torch.HFSpeechMixEED(
        "tiny-speech", "tiny-bart-bytes", down_scale=down_scale,
        device="cpu")
    model.params = convert.params_from_jax(tree, model.config)
    if speech_layers is not None:
        model.params["speech_encoder"] = se.truncate_layers(
            model.params["speech_encoder"], speech_layers)
    return model


def serving_cases(rank, tree, waveforms, cases):
    """TranscriptionPipeline over each case's mesh (optionally on int8
    weights): every rank's transcripts."""
    from speechmix_tpu_torch import pipeline as t_pipe
    from speechmix_tpu_torch.utils.quantize import quantize_weights
    out = []
    for case in cases:
        mesh = mesh_lib.make_mesh(*case["mesh"], device="cpu")
        if mesh is None:
            out.append(None)
            continue
        model = _tiny_model(tree)
        if case.get("int8_weights"):
            model.params = quantize_weights(model.params, min_size=1)
        pipe = t_pipe.TranscriptionPipeline(model, mesh=mesh, **case["kw"])
        out.append({"coords": _coords(mesh), "texts": pipe(waveforms)})
    return out


# the synthetic corpus's 4 s buckets fit tiny-bart-bytes's 512 positions;
# one speech layer keeps the plain attention over its 3200 frames short
DATA_DOWN_SCALE = 8
DATA_SPEECH_LAYERS = 1


class _Args:
    """The train command's options that build_datasets reads."""

    def __init__(self, **kw):
        self.__dict__.update(dict(
            batch=2, grad_accum=1, prompt="", synthetic=True, dataset=None,
            custom_set=None, field="text", train_split="train",
            test_split="test", seed=0, cache=False,
            max_input_length_in_sec=20, worker=1, group_by_length=True,
            multihost=False), **kw)


def multihost_data(rank, tree, steps, tc_kw):
    """build_datasets(multihost=True) over (2, 1, 1): each rank's batches
    (their shapes) and the losses of `steps` DP steps on them."""
    from speechmix_tpu_torch.data.datasets import build_datasets
    mesh = mesh_lib.make_mesh(2, 1, 1, device="cpu")
    if mesh is None:
        return None
    model = _tiny_model(tree, DATA_DOWN_SCALE, DATA_SPEECH_LAYERS)
    train, _ = build_datasets(_Args(multihost=True, batch=2), model,
                              device="cpu", mesh=mesh)
    tc = t_trainer.TrainConfig(**tc_kw)
    params = model.params
    full = t_trainer.TrainState(params,
                                t_trainer.make_optimizer(tc).init(params), 0)
    state = t_trainer.shard_train_state(full, mesh, model.config, tc)
    step_fn = t_trainer.make_train_step(model.config, tc, state.params,
                                        mesh=mesh)
    shapes, losses = [], []
    for batch in train():
        if len(losses) == steps:
            break
        shapes.append({k: np.asarray(v).shape for k, v in batch.items()})
        state, m = step_fn(state, mesh_lib.shard_batch(mesh, batch))
        losses.append(float(m["loss"]))
    return {"shapes": shapes, "losses": losses}


def fit_runs(rank, tree, batch, evals, runs):
    """Trainer.fit over each run's mesh from the one-card state of `tree`
    (mesh, tc kwargs with output_dir) on this data rank's rows of `batch`
    at every step (a resumed run starts its epoch again, so only a fixed
    batch lets it continue as the uninterrupted run does) and of the eval
    batches; rank 0 returns its final whole parameters in the JAX
    layout."""
    out = []
    for run in runs:
        mesh = mesh_lib.make_mesh(*run["mesh"], device="cpu")
        if mesh is None:
            out.append(None)
            continue
        model = _tiny_model(tree)
        tc = t_trainer.TrainConfig(**run["tc"])
        rows = lambda b, accum: {
            k: np.asarray(v)[mesh_lib.local_batch_index(
                len(v), mesh.n_data, mesh.data_rank, accum)]
            for k, v in b.items()}
        mine = rows(batch, tc.grad_accum)
        mine_eval = [rows(b, 1) for b in evals]
        trainer = t_trainer.Trainer(model.config, tc,
                                    tokenizer=model.tokenizer, device="cpu",
                                    mesh=mesh)
        full = t_trainer.TrainState(
            model.params, t_trainer.make_optimizer(tc).init(model.params), 0)
        state = t_trainer.shard_train_state(full, mesh, model.config, tc)
        state = trainer.fit(state, lambda: iter([mine] * 8),
                            lambda: iter(mine_eval))
        layout = sharded.StepLayout(mesh, model.config, state.params,
                                    tc.optimizer, tc.zero1, False)
        whole = sharded.full_state(state, layout,
                                   t_trainer.make_optimizer(tc))
        out.append({"coords": _coords(mesh), "step": state.step,
                    "params": _jax_layout_flat(whole.params)
                    if rank == 0 else None})
    return out


def dropout_cases(rank, tree, batch, tc_kw, runs):
    """Dropout-on train steps at (2, 2, 1), each run twice from one state:
    the losses, the skipped layers, the replicated leaves' bytes, and the
    logits' checksum of a dropout forward whose data ranks get the same
    rows (their masks must differ; their model ranks' must not)."""
    from speechmix_tpu_torch.models import speechmix as t_smx
    mesh = mesh_lib.make_mesh(2, 2, 1, device="cpu")
    cfg = build_config(("tiny-speech", "tiny-bart-bytes", 4, 2, "eed"))
    import dataclasses
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, layerdrop=0.5))
    tc = t_trainer.TrainConfig(**tc_kw)
    res = {"coords": _coords(mesh), "runs": []}
    for _ in range(runs):
        params = convert.params_from_jax(tree, cfg)
        full = t_trainer.TrainState(
            params, t_trainer.make_optimizer(tc).init(params), 0)
        state = t_trainer.shard_train_state(full, mesh, cfg, tc)
        step_fn = t_trainer.make_train_step(cfg, tc, state.params,
                                            device="cpu", mesh=mesh)
        losses, skipped = [], []
        for _ in range(2):
            state, m = step_fn(state, mesh_lib.local_batch(
                mesh, batch, tc.grad_accum))
            losses.append(float(m["loss"]))
            skipped.append(m["layers_skipped"])
        res["runs"].append({"losses": losses, "skipped": skipped,
                            "replicated": _replicated_leaves(
                                state, step_fn.layout)})
    # the same two rows on both data ranks
    same = {k: np.concatenate([v[:2], v[:2]]) for k, v in batch.items()}
    local = mesh_lib.local_batch(mesh, same)
    key = t_trainer.dropout_keys(tc, 0)[0]
    with torch.no_grad(), mesh_lib.tp_sharding(mesh):
        out = t_smx.speechmix_forward(
            state.params, cfg, local["input_values"],
            lengths=local["lengths"], labels=local["labels"],
            dropout_rng=key)
    res["logits_sum"] = float(out["logits"].double().sum())
    return res


def mesh_cases(rank, shapes):
    """make_mesh of each shape: this rank's coordinates and the global
    ranks of its data / model / seq groups (None outside the mesh)."""
    out = []
    for shape in shapes:
        mesh = mesh_lib.make_mesh(*shape, device="cpu")
        out.append(None if mesh is None else {
            "coords": _coords(mesh),
            "ranks": {a: mesh.ranks(a) for a in mesh_lib.AXES},
            "sum": {a: float(collectives.all_reduce(
                torch.tensor([float(rank)]), mesh.group(a))[0])
                for a in mesh_lib.AXES}})
    return out


def remat_gradients(rank, tree, batch):
    """The gradients of one f32 step at (1, 2, 2) (TP and the ring) with
    the layers rematerialised and without: equal bit for bit (the
    recomputed forward runs in the backward, under the same mesh)."""
    import dataclasses
    mesh = mesh_lib.make_mesh(1, 2, 2, device="cpu")
    base = build_config(("tiny-speech", "tiny-bart-bytes", 4, 2, "eed"))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(
            base, encoder=dataclasses.replace(base.encoder, remat=remat),
            decoder=dataclasses.replace(base.decoder, remat=remat))
        tc = t_trainer.TrainConfig(dropout=False, optimizer="adamw",
                                   fixed_nlp=False, model_parallel=2,
                                   sequence_parallel=2)
        params = convert.params_from_jax(tree, cfg)
        full = t_trainer.TrainState(
            params, t_trainer.make_optimizer(tc).init(params), 0)
        state = t_trainer.shard_train_state(full, mesh, cfg, tc)
        step_fn = t_trainer.make_train_step(cfg, tc, state.params,
                                            device="cpu", mesh=mesh)
        grads, norm, _ = step_fn.gradients(
            state, mesh_lib.local_batch(mesh, batch))
        out.append([g.numpy().tobytes()
                    for _, g in t_trainer.tree_paths(grads)] + [float(norm)])
    return out[0] == out[1]


def gated_t5_gradients(rank, tree, batch):
    """A gated-GELU T5 pair (tiny-t5-bytes with fc_gate: T5's per-head
    position bias sliced to the local heads, fc_gate column-parallel like
    fc1) at (1, 2, 1): the whole gradient tree gathered over the model
    group, and the same step's on this rank without a mesh; the largest
    difference over each leaf's largest magnitude plus 0.1 of the tree's
    largest gradient."""
    import dataclasses
    base = build_config(("tiny-speech", "tiny-t5-bytes", 2, 2, "eed"))
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, activation="gelu_gated"))
    tc = t_trainer.TrainConfig(dropout=False, optimizer="adamw",
                               fixed_nlp=False, model_parallel=2)
    mesh = mesh_lib.make_mesh(1, 2, 1, device="cpu")
    if mesh is None:
        return None
    params = convert.params_from_jax(tree, cfg)
    full = t_trainer.TrainState(params,
                                t_trainer.make_optimizer(tc).init(params), 0)
    single = t_trainer.make_train_step(cfg, tc, params, device="cpu")
    want, want_norm, _ = single.gradients(full, batch)
    state = t_trainer.shard_train_state(full, mesh, cfg, tc)
    step_fn = t_trainer.make_train_step(cfg, tc, state.params, device="cpu",
                                        mesh=mesh)
    got, norm, _ = step_fn.gradients(state, mesh_lib.local_batch(mesh,
                                                                 batch))
    worst, where = 0.0, None
    top = max(float(w.abs().max()) for _, w in t_trainer.tree_paths(want))
    for (path, g), (_, p), (_, w) in zip(t_trainer.tree_paths(got),
                                         t_trainer.tree_paths(state.params),
                                         t_trainer.tree_paths(want)):
        g = sharded._gather_model(g, step_fn.layout.model_dim(p), mesh)
        # attention key biases' gradient is rounding noise (zero in exact
        # arithmetic): the tree's scale bounds it
        scale = float(w.abs().max()) + 1e-1 * top
        err = float((g - w).abs().max()) / scale
        if err > worst:
            worst, where = err, (path, float(w.abs().max()))
    return {"worst": worst, "where": where,
            "norm": (float(norm), float(want_norm)),
            "split": sum(step_fn.layout.model_dim(p) is not None
                         for _, p in t_trainer.tree_paths(state.params))}


def mesh_and_dropout(rank, shapes, tree, batch, tc_kw, t5_tree):
    """mesh_cases, dropout_cases (two runs), remat_gradients and
    gated_t5_gradients, in one process."""
    return (mesh_cases(rank, shapes),
            dropout_cases(rank, tree, batch, tc_kw, 2),
            remat_gradients(rank, tree, batch),
            gated_t5_gradients(rank, t5_tree, batch))


def train_command(rank, argv, world):
    """`python -m speechmix_tpu_torch.train argv` as rank `rank` of a
    torchrun world of `world` (the group is up already); its stdout."""
    import contextlib
    import io
    import os
    from speechmix_tpu_torch import train as t_train
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        t_train.main(argv)
    return out.getvalue()
