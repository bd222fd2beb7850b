"""The system under test, driven as a user drives it: the port's
``generation.generate`` (batched transcription) and the step that
``training.trainer.make_train_step`` builds, with the benchmark's weights
and traffic.  Nothing of the port is imported before a session is made.

A session holds what one run needs: ``warm()`` (set-up: the cell's own
shapes, and for training the first three steps that the reference
follows), ``call(i)`` (one call or step of the window, returns the valid
audio seconds it carried, worked out on the host at set-up, so that the
call touches no device value before it returns; the caller
synchronises), ``ops(i)`` (the work
of call i, ``flops``) and ``release()`` (frees the program's state before
the reference runs).
"""

from __future__ import annotations

import json

import torch

from . import flops, traffic, weights
from .reference import optim

FIRST_STEPS = 3


def port_config(cfg_file):
    from speechmix_tpu_torch.config import SpeechMixConfig
    return SpeechMixConfig.from_json(json.dumps(cfg_file["speechmix"]))


class Session:
    def __init__(self, cfg_file, mix, seed, device):
        self.cfg = cfg_file["speechmix"]
        self.port_cfg = port_config(cfg_file)
        self.mix, self.seed, self.device = mix, seed, torch.device(device)
        self.params = weights.make(self.cfg, traffic.sub_seed(seed,
                                                              "weights"),
                                   self.device)
        self.pool = traffic.make_pool(
            mix, seed, self.device, self.port_cfg.encoder.aligned_samples,
            self.cfg["decoder"]["vocab_size"])
        self.padded = self.pool[0]["input_values"].shape[1]
        self.samples = sorted(self.pool[0]["lengths"].tolist())
        self.audio_s = [traffic.audio_seconds(b) for b in self.pool]

    def batch(self, i):
        return self.pool[i % len(self.pool)]


class Transcribe(Session):
    """Greedy ``generate`` over the pool, batch by batch, with the scores it
    returns (HF's output_scores: the processed logits of every step).  Of
    each window call one row, drawn from the seed, is kept for the check:
    its tokens and its scores."""
    train = False

    def __init__(self, cfg_file, mix, seed, device):
        super().__init__(cfg_file, mix, seed, device)
        self.dtype = getattr(torch, mix["dtype"])
        self.kept = []
        self._ops = flops.generate_ops(self.cfg, mix["batch"], self.padded,
                                       self.samples, mix["max_length"])

    def _generate(self, batch):
        """(tokens (B, L), scores (L, B, V))."""
        from speechmix_tpu_torch import generation
        with torch.no_grad():
            tokens, _, scores = generation.generate(
                self.params, self.port_cfg, batch["input_values"],
                batch["lengths"], max_length=self.mix["max_length"],
                min_length=self.mix.get("min_length", 0), dtype=self.dtype,
                output_scores=True, device=self.device)
        return tokens, scores

    def warm(self):
        for batch in self.pool:
            self._generate(batch)
        return {}

    def row(self, i):
        """The row of call i that the check compares."""
        return traffic.sub_seed(self.seed, f"row {i}") % self.mix["batch"]

    def call(self, i):
        batch = self.batch(i)
        tokens, scores = self._generate(batch)
        r = self.row(i)
        self.kept.append((i % len(self.pool), r, tokens[r].clone(),
                          scores[:, r].clone()))
        return self.audio_s[i % len(self.pool)]

    def ops(self, i):
        return self._ops

    def release(self):
        self.params = None


class Train(Session):
    """The train step over the pool, step by step.  Set-up runs its first
    three steps, on three different batches, and keeps what the check
    compares: each step's loss, each leaf's first gradient norm as the
    optimizer took it (from its state after step 1) and each leaf's change
    over the three steps."""
    train = True

    def __init__(self, cfg_file, mix, seed, device):
        super().__init__(cfg_file, mix, seed, device)
        from speechmix_tpu_torch.training import trainer
        # the recipe's dropout key chain (TrainConfig's seed, 0 by default)
        # is the same in every run, so LayerDrop skips the same layers and
        # every seed carries the same work
        self.recipe = dict(mix["recipe"])
        self.tc = trainer.TrainConfig(**self.recipe)
        self.dropout_seed = self.tc.seed
        self.state = trainer.TrainState(
            self.params, trainer.make_optimizer(self.tc).init(self.params), 0)
        self.step_fn = trainer.make_train_step(self.port_cfg, self.tc,
                                               self.params,
                                               device=self.device)
        self.skipped = []
        self.losses = []

    def call(self, i):
        batch = self.batch(i)
        self.state, metrics = self.step_fn(self.state, batch)
        self.skipped.append(metrics["layers_skipped"][0])
        self.last = metrics
        return self.audio_s[i % len(self.pool)]

    def warm(self):
        start = {n: [t.clone() for t in ts]
                 for n, ts, _, _ in optim.groups(self.params)}
        first = None
        for i in range(FIRST_STEPS):
            self.call(i)
            self.losses.append(float(self.last["loss"]))
            if i == 0:
                first = self.first_gradient_norms()
        delta = {}
        for name, ts, conv, stacked in optim.groups(self.state.params):
            d = optim.jax_view(ts, conv, stacked) - optim.jax_view(
                start[name], conv, stacked)
            delta[name] = float(torch.linalg.vector_norm(d))
        del start
        self.readings = {"loss": list(self.losses), "grad_norm": first,
                         "delta_norm": delta,
                         "skipped": list(self.skipped[:FIRST_STEPS])}
        return self.readings

    def first_gradient_norms(self):
        """Each leaf's gradient norm as the optimizer took it at step 1,
        from its second-moment statistics: at the first update they are g^2
        + 1e-30 (decay 0), a factored leaf's row means over its largest
        axis."""
        from speechmix_tpu_torch.convert import flatten_with_paths
        stats = {k: dict(flatten_with_paths(self.state.opt_state[k]))
                 for k in ("v_row", "v_col", "v")}
        out = {}
        for name, ts, conv, stacked in optim.groups(self.state.params):
            shape = optim.jax_shape(ts, conv, stacked)
            dims = optim.factored_dims(shape)
            if dims is None:
                total = float(stats["v"][name].double().sum())
            else:
                total = float(stats["v_row"][name].double().sum()) \
                    * shape[dims[1]]
            n = 1
            for s in shape:
                n *= s
            out[name] = max(total - n * optim.EPS, 0.0) ** 0.5
        return out

    def ops(self, i):
        return flops.train_ops(self.cfg, self.mix["batch"], self.padded,
                               self.samples, self.mix["label_positions"],
                               self.skipped[i], self.tc.dropout)

    def release(self):
        self.state = self.step_fn = self.last = self.params = None
