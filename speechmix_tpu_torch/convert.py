"""Weight bridge from the JAX package's parameter tree to the port's.

``params_from_jax(tree, cfg)`` takes the JAX tree as nested dicts and lists
of numpy arrays (what ``jax.tree_util.tree_map(np.asarray, params)`` gives)
and returns the port's parameters:

* layer stacks scanned on a leading axis (``speech_encoder.layers``,
  ``nlp.encoder.layers``, ``nlp.decoder.layers``) become lists of per-layer
  dicts;
* dense kernels keep the ``(in, out)`` layout;
* conv kernels ``(K, C_in, C_out)`` become PyTorch's ``(C_out, C_in, K)``
  (the extractor convs, the length adapters, and the positional conv, whose
  weight norm the JAX tree already holds merged into one kernel);
* floating tensors of two or more dimensions are cast to `dtype` (bf16 for
  serving, as the JAX benchmark casts its matrices); biases and LayerNorm
  parameters stay float32;
* a T5 model's leaves are carried under the JAX package's names: each
  stack's ``rel_bias`` table (num_buckets, H) and ``final_layer_norm``
  scale, ``fc_gate`` of a gated FFN, an untied ``lm_head``; the absent
  biases, positions and ``final_logits_bias`` stay absent.  The table is a
  matrix, so it takes `dtype` (bf16 in a bf16 tree, as a bf16 JAX tree
  holds it); ``models.seq2seq.t5_position_bias`` reads it in float32 and
  the bias is added to the attention logits in float32;
* the speech encoder's ``masked_spec_embed`` (SpecAugment's replacement
  vector, float32) is carried when the tree has it, first in the speech
  encoder's entries (HF's registration order);
* the ``adapter`` variant's adapters, stacked per side in the JAX tree,
  become lists per side; the ``gan`` variant's ``discriminator`` dense is
  carried as it is.  The pre-LN speech encoder has the post-LN one's leaves.

``tree_to_jax_layout`` walks the other way, for a tree shaped like the
port's parameters (the parameters themselves, or their gradients): numpy
arrays in the JAX package's layout, layer lists stacked again.
``jax_layout_groups`` gives, for each leaf of that layout, the port's
tensors it is made of (the optimizer's view of the JAX layout).
``adafactor_state_to_jax`` / ``adafactor_state_from_jax`` and
``adamw_state_to_jax`` / ``adamw_state_from_jax`` carry the optimizer state
between the port and the layout of optax's ``FactoredState`` and
``ScaleByAdamState``.  ``train_state_to_jax`` / ``train_state_from_jax``
carry a whole port ``TrainState`` to and from the tree that the JAX
package's checkpoints hold, ``{"params", "opt_state", "step"}``, under the
JAX package's key strings (``flatten_with_paths``), so that a checkpoint
written by either package restores in the other.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import SpeechMixConfig


def _tensor(a, dtype, device):
    t = torch.tensor(np.asarray(a), device=device)
    if t.is_floating_point():
        t = t.to(dtype if t.ndim >= 2 else torch.float32)
    return t


def _conv(p, dtype, device):
    out = {"kernel": _tensor(np.asarray(p["kernel"]).transpose(2, 1, 0),
                             dtype, device)}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"], dtype, device)
    return out


def _unstack(stacked, dtype, device):
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(stacked)
    n = np.asarray(leaves[0]).shape[0]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return _tensor(np.asarray(t)[i], dtype, device)
    return [take(stacked, i) for i in range(n)]


def _plain(t, dtype, device):
    if isinstance(t, dict):
        return {k: _plain(v, dtype, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_plain(v, dtype, device) for v in t]
    return _tensor(t, dtype, device)


def params_from_jax(tree, cfg: SpeechMixConfig, dtype=torch.float32,
                    device="cpu"):
    """The port's parameters for a JAX ``init_speechmix``/``load_speechmix``
    tree of numpy arrays (see the module docstring)."""
    se = tree["speech_encoder"]
    enc = {}
    if "masked_spec_embed" in se:
        enc["masked_spec_embed"] = _tensor(se["masked_spec_embed"], dtype,
                                           device)
    enc.update({
        "feature_extractor": {"layers": [
            {k: (_conv(v, dtype, device) if k == "conv"
                 else _plain(v, dtype, device)) for k, v in layer.items()}
            for layer in se["feature_extractor"]["layers"]]},
        "feature_projection": _plain(se["feature_projection"], dtype, device),
        "pos_conv": _conv(se["pos_conv"], dtype, device),
        "encoder_layer_norm": _plain(se["encoder_layer_norm"], dtype, device),
        "layers": _unstack(se["layers"], dtype, device),
    })
    nlp = {k: v for k, v in tree["nlp"].items()
           if k not in ("encoder", "decoder")}
    nlp = _plain(nlp, dtype, device)
    for side in ("encoder", "decoder"):
        part = tree["nlp"][side]
        nlp[side] = {k: (_unstack(v, dtype, device) if k == "layers"
                         else _plain(v, dtype, device))
                     for k, v in part.items()}
    out = {
        "speech_encoder": enc,
        "nlp": nlp,
        "enc_to_dec_proj": _plain(tree["enc_to_dec_proj"], dtype, device),
        "length_adapter": [_conv(c, dtype, device)
                           for c in tree["length_adapter"]],
    }
    if cfg.weighted_sum:
        out["weights_sum"] = _plain(tree["weights_sum"], dtype, device)
    if "adapters" in tree:
        out["adapters"] = {side: _unstack(v, dtype, device)
                           for side, v in tree["adapters"].items()}
    if "discriminator" in tree:
        out["discriminator"] = _plain(tree["discriminator"], dtype, device)
    return out


def cross_kv_from_jax(a, device="cpu"):
    """A cross K or V array of the JAX package's decoder cache, stored
    batch-minor (L, T_enc, H, D, B) in the compute dtype or as int8 codes,
    in the port's (L, B, T_enc, H, D) layout.  (The scales are (L, B, T_enc,
    H) in both packages.)"""
    return torch.tensor(np.ascontiguousarray(
        np.asarray(a).transpose(0, 4, 1, 2, 3)), device=device)


def _numpy(t):
    return t.detach().float().cpu().numpy()


def _stacked_in_jax(path, key):
    """The layer lists the JAX package stacks on a leading axis: the three
    transformer stacks and the adapters of each side."""
    return ((key == "layers" and path[-1:] != ("feature_extractor",))
            or path[-1:] == ("adapters",))


def _zip_layers(trees, stack):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_layers([t[k] for t in trees], stack) for k in first}
    return stack(trees)


def _jax_layout(tree, leaf, stack, path=()):
    """A port-shaped tree walked into the JAX package's layout: leaf(t,
    conv) for each tensor (conv: a conv kernel, (C_out, C_in, K) here,
    (K, C_in, C_out) there), stack(values) for the layers of a list that the
    JAX package stacks."""
    if isinstance(tree, dict):
        if "kernel" in tree and tree["kernel"].ndim == 3:   # a convolution
            return {k: leaf(v, k == "kernel") for k, v in tree.items()}
        return {k: (_zip_layers([_jax_layout(layer, leaf, stack)
                                 for layer in v], stack)
                    if _stacked_in_jax(path, k)
                    else _jax_layout(v, leaf, stack, path + (k,)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_layout(v, leaf, stack, path) for v in tree]
    return leaf(tree, False)


def tree_to_jax_layout(tree):
    """The inverse walk of params_from_jax for a tree shaped like the port's
    parameters (parameters or gradients): float32 numpy arrays, the three
    transformer layer lists and the adapters stacked on a leading axis, conv
    kernels as (K, C_in, C_out)."""
    def leaf(t, conv):
        a = _numpy(t)
        return a.transpose(2, 1, 0) if conv else a
    return _jax_layout(tree, leaf, np.stack)


class LayoutGroup:
    """One leaf of the JAX layout: the port tensors it is made of (one per
    layer of a stacked list, else one), whether they are stacked on a new
    leading axis, and whether the leaf is a conv kernel (its JAX layout the
    reverse of the port's axes)."""

    def __init__(self, tensors, stacked, conv):
        self.tensors, self.stacked, self.conv = tensors, stacked, conv

    @property
    def shape(self):
        """The leaf's shape in the JAX layout."""
        shape = tuple(self.tensors[0].shape)
        if self.conv:
            shape = shape[::-1]
        return (len(self.tensors),) + shape if self.stacked else shape

    def gather(self):
        """The leaf in the JAX layout (a copy when stacked)."""
        if self.stacked:
            return torch.stack(self.tensors)
        t = self.tensors[0]
        return t.permute(2, 1, 0) if self.conv else t

    def views(self, x):
        """Views of `x`, a tensor in the JAX layout, shaped as the port
        tensors, in their order."""
        if self.stacked:
            return list(x.unbind(0))
        return [x.permute(2, 1, 0) if self.conv else x]


def jax_layout_groups(tree):
    """The JAX layout of a port-shaped tree of tensors, with a LayoutGroup
    in place of each leaf."""
    return _jax_layout(
        tree, lambda t, conv: LayoutGroup([t], False, conv),
        lambda groups: LayoutGroup([g.tensors[0] for g in groups], True,
                                   groups[0].conv))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def adafactor_state_to_jax(opt_state):
    """The port's Adafactor state as optax's FactoredState holds it for the
    JAX tree of the same parameters: {"count", "v_row", "v_col", "v"}, each
    statistics tree in the JAX layout (which the port's Adafactor keeps)
    with float32 numpy leaves; a leaf's unused statistics are zeros of
    shape (1,), as in optax."""
    return {"count": opt_state["count"],
            **{k: _map_leaves(_numpy, opt_state[k])
               for k in ("v_row", "v_col", "v")}}


def _stat_groups(tree):
    """A tree of tensors already in the JAX layout (Adafactor's statistics),
    with a LayoutGroup of one tensor in place of each."""
    return _map_leaves(lambda t: LayoutGroup([t], False, False), tree)


def _copy_into(group, array, path):
    """Write `array`, a leaf in the JAX layout, into the port tensors of
    LayoutGroup `group` with copy_."""
    a = torch.tensor(np.asarray(array))
    if tuple(a.shape) != tuple(group.shape):
        raise ValueError(f"{path}: shape {tuple(a.shape)}, expected "
                         f"{tuple(group.shape)}")
    for t, v in zip(group.tensors, group.views(a)):
        t.copy_(v)


@torch.no_grad()
def _write(groups, arrays):
    flat = dict(flatten_with_paths(arrays))
    for path, group in flatten_with_paths(groups):
        _copy_into(group, flat[path], path)


def adafactor_state_from_jax(state, opt_state):
    """The inverse of adafactor_state_to_jax: `state` (a FactoredState's
    {"count", "v_row", "v_col", "v"}, numpy leaves in the JAX layout)
    written into the statistics tensors of the port's Adafactor state
    `opt_state` in place (copy_); returns the state with the new count."""
    for k in ("v_row", "v_col", "v"):
        _write(_stat_groups(opt_state[k]), state[k])
    return {**opt_state, "count": int(np.asarray(state["count"]))}


def adamw_state_to_jax(opt_state):
    """The port's AdamW state as optax's ScaleByAdamState holds it for the
    JAX tree of the same parameters: {"count", "mu", "nu"}, the moments in
    the JAX layout with float32 numpy leaves."""
    return {"count": opt_state["count"],
            "mu": tree_to_jax_layout(opt_state["mu"]),
            "nu": tree_to_jax_layout(opt_state["nu"])}


def adamw_state_from_jax(state, opt_state):
    """The inverse of adamw_state_to_jax: the moments written into the
    tensors of the port's AdamW state `opt_state` in place (copy_); returns
    the state with the new count."""
    for k in ("mu", "nu"):
        _write(jax_layout_groups(opt_state[k]), state[k])
    return {**opt_state, "count": int(np.asarray(state["count"]))}


# ----------------------------------------------------------------------------
# the JAX package's checkpoint tree
# ----------------------------------------------------------------------------

# optax's state of chain(clip_by_global_norm, inner) is (EmptyState(),
# inner's state): index "1" holds inner's chain, "0" of it the moments'
# NamedTuple and "2" the ScaleByScheduleState; NamedTuple fields flatten
# as ".name", in field order
_OPT_FIELDS = {"adafactor": ("v_row", "v_col", "v"), "adamw": ("mu", "nu")}
# leaves added to the JAX tree after checkpoints were written: absent from
# an archive, the live value is kept (with a warning); any other missing
# leaf raises
_OPTIONAL_LEAF_SUBSTRINGS = ("masked_spec_embed",)


def _jax_sorted(tree):
    """`tree` with its dicts in the JAX package's flattening order (sorted
    keys)."""
    if isinstance(tree, dict):
        return {k: _jax_sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_jax_sorted(v) for v in tree]
    return tree


def _optimizer_name(opt_state):
    return "adafactor" if "v_row" in opt_state else "adamw"


def train_state_to_jax(state):
    """A port TrainState as the tree the JAX package checkpoints,
    {"opt_state", "params", "step"} in its flattening order: the parameters
    and moments in the JAX layout (float32 numpy arrays), the counts and the
    step int32 scalars.  A synchronous copy to the host."""
    opt = state.opt_state
    name = _optimizer_name(opt)
    count = np.asarray(opt["count"], np.int32)
    stats = (adafactor_state_to_jax(opt) if name == "adafactor"
             else adamw_state_to_jax(opt))
    first = {".count": count,
             **{f".{k}": _jax_sorted(stats[k]) for k in _OPT_FIELDS[name]}}
    return {"opt_state": {"1": {"0": first, "2": {".count": count}}},
            "params": _jax_sorted(tree_to_jax_layout(state.params)),
            "step": np.asarray(state.step, np.int32)}


def flatten_with_paths(tree, prefix=""):
    """[(path, leaf)] of a tree of dicts and lists in its order, with the
    JAX package's "/"-joined key strings (utils.pytree.keypath_str)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _state_targets(state):
    """The paths of train_state_to_jax(state), each with the LayoutGroup of
    port tensors it is written into (None for a count and the step)."""
    opt = state.opt_state
    name = _optimizer_name(opt)
    groups = _stat_groups if name == "adafactor" else jax_layout_groups
    first = {".count": None,
             **{f".{k}": _jax_sorted(groups(opt[k]))
                for k in _OPT_FIELDS[name]}}
    return flatten_with_paths(
        {"opt_state": {"1": {"0": first, "2": {".count": None}}},
         "params": _jax_sorted(jax_layout_groups(state.params)),
         "step": None})


@torch.no_grad()
def train_state_from_jax(tree, state):
    """Write the JAX checkpoint tree `tree` (nested as train_state_to_jax
    gives it, or flat {path: array}) into the tensors of the port TrainState
    `state` with copy_, so that a step function built on `state` (its
    in-place update, its static mask) still holds; returns the TrainState
    with the restored counts and step.  An optional leaf (masked_spec_embed)
    missing from `tree` keeps its live value, with a warning; any other
    missing leaf raises KeyError."""
    flat = dict(flatten_with_paths(tree))
    for path, group in _state_targets(state):
        if path not in flat:
            if any(s in path for s in _OPTIONAL_LEAF_SUBSTRINGS):
                warnings.warn(f"checkpoint predates parameter {path}; "
                              "keeping the initialized value")
                continue
            raise KeyError(f"checkpoint missing parameter {path}")
        if group is not None:
            _copy_into(group, flat[path], path)
    count = int(np.asarray(flat["opt_state/1/0/.count"]))
    return type(state)(state.params, {**state.opt_state, "count": count},
                       int(np.asarray(flat["step"])))
