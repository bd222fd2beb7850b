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
written by either package restores in the other; ``params_to_jax_paths`` /
``params_from_jax_paths`` do the same for the parameters alone (the API's
weights.npz).

HF / fairseq checkpoints (torch state dicts in pytorch_model.bin or
model.safetensors): ``load_speech_encoder`` (wav2vec2 / HuBERT /
UniSpeechSAT, the HF or the fairseq layout), ``load_seq2seq`` (BART / T5 /
gated ByT5), ``load_speechmix`` (a whole reference HFSpeechMixEED-family
state dict) and ``load_speechmix_ed`` (HFSpeechMixED) map the keys as the
JAX package does into its numpy layout and hand it to the converters
above; ``export_speechmix`` is the inverse of ``load_speechmix``;
``config_from_hf`` derives the configuration from a config.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def speech_encoder_from_jax(se, dtype=torch.float32, device="cpu"):
    """The port's speech-encoder parameters for a JAX speech-encoder tree
    of numpy arrays (``params["speech_encoder"]``, a CTC model's
    ``params["encoder"]``, or what the JAX checkpoint loaders give)."""
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
    return enc


def seq2seq_from_jax(tree, dtype=torch.float32, device="cpu"):
    """The port's BART / T5 parameters for a JAX seq2seq tree of numpy
    arrays (``params["nlp"]``)."""
    nlp = _plain({k: v for k, v in tree.items()
                  if k not in ("encoder", "decoder")}, dtype, device)
    for side in ("encoder", "decoder"):
        nlp[side] = {k: (_unstack(v, dtype, device) if k == "layers"
                         else _plain(v, dtype, device))
                     for k, v in tree[side].items()}
    return nlp


def params_from_jax(tree, cfg: SpeechMixConfig, dtype=torch.float32,
                    device="cpu"):
    """The port's parameters for a JAX ``init_speechmix``/``load_speechmix``
    tree of numpy arrays (see the module docstring)."""
    enc = speech_encoder_from_jax(tree["speech_encoder"], dtype, device)
    out = {
        "speech_encoder": enc,
        "nlp": seq2seq_from_jax(tree["nlp"], dtype, device),
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


def params_to_jax_paths(params):
    """The port's parameters as the JAX package's parameter tree, in its
    flattening order (float32 numpy arrays), for save_pytree_npz."""
    return _jax_sorted(tree_to_jax_layout(params))


def _copy_paths(flat, targets, source="checkpoint"):
    """Copy flat[path] into each target LayoutGroup (None: nothing to
    copy).  An optional leaf (masked_spec_embed) missing from `flat` keeps
    its value, with a warning; any other missing leaf raises KeyError."""
    for path, group in targets:
        if path not in flat:
            if any(s in path for s in _OPTIONAL_LEAF_SUBSTRINGS):
                warnings.warn(f"{source} predates parameter {path}; keeping "
                              "the initialized value")
                continue
            raise KeyError(f"{source} missing parameter {path}")
        if group is not None:
            _copy_into(group, flat[path], path)


@torch.no_grad()
def params_from_jax_paths(flat, params, source="checkpoint"):
    """Write `flat`, {JAX key string: array} of the JAX package's parameter
    tree (what load_pytree_npz gives for an archive of either package),
    into the port's `params` in place (copy_, cast to each tensor's dtype),
    missing leaves as _copy_paths treats them."""
    _copy_paths(flat, flatten_with_paths(jax_layout_groups(params)), source)
    return params


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
    _copy_paths(flat, _state_targets(state))
    count = int(np.asarray(flat["opt_state/1/0/.count"]))
    return type(state)(state.params, {**state.opt_state, "count": count},
                       int(np.asarray(flat["step"])))


# ----------------------------------------------------------------------------
# HF / fairseq checkpoints: torch state dicts -> the port's parameters
#
# The key maps are the JAX package's: each builds the JAX package's tree of
# numpy arrays (kernels (in, out), convs (K, in/groups, out), layers stacked
# on a leading axis), which speech_encoder_from_jax / seq2seq_from_jax /
# params_from_jax turn into the port's tensors, so a checkpoint loads into
# both packages with the same numbers.
# ----------------------------------------------------------------------------

def load_state_dict(path: str, allow_pickle: bool = True):
    """{name: numpy array} of a torch / safetensors state dict in a file or
    a checkpoint directory (model.safetensors, else pytorch_model.bin).

    ``allow_pickle`` gates the unrestricted ``torch.load`` fallback that
    fairseq / s3prl checkpoints need (they pickle an args Namespace beside
    the weights): it fires only on the weights-only loader's
    UnpicklingError, never on I/O or corruption errors, and warns with the
    file name.  A .safetensors file needs the safetensors package, imported
    here; without it the ImportError names the file."""
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
    if path.endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file
        except ImportError as err:
            raise ImportError(f"{path}: reading a .safetensors file needs "
                              "the safetensors package") from err
        return {k: np.asarray(v) for k, v in load_file(path).items()}
    import pickle
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not allow_pickle:
            raise
        warnings.warn(
            f"{path}: weights-only load rejected (non-tensor pickled "
            "objects, typical of fairseq/s3prl checkpoints); retrying with "
            "weights_only=False. Pass allow_pickle=False to forbid this "
            "for untrusted files.", stacklevel=2)
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and not any(
            hasattr(v, "detach") for v in sd.values()):
        # fairseq layout: {"args"/"cfg": ..., "model": OrderedDict}
        for key in ("model", "state_dict"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    return {k: v.detach().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _numpy_state_dict(sd):
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in sd.items()}


def _strip_prefix(sd, prefixes=("model.", "wav2vec2.", "hubert.",
                                "unispeech_sat.")):
    """Normalize key prefixes across checkpoint flavors."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _lin(sd, name):
    p = {"kernel": np.asarray(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def _ln(sd, name):
    return {"scale": np.asarray(sd[f"{name}.weight"]),
            "bias": np.asarray(sd[f"{name}.bias"])}


def _rms(sd, name):
    return {"scale": np.asarray(sd[f"{name}.weight"])}


def _jconv(sd, name):
    """A torch conv (out, in/groups, K) in the JAX layout (K, in/groups,
    out)."""
    p = {"kernel": np.asarray(sd[f"{name}.weight"]).transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        p["bias"] = np.asarray(sd[f"{name}.bias"])
    return p


def _stack(trees):
    return _zip_layers(trees, np.stack)


def _materialize_weight_norm(sd, base):
    """wav2vec2 pos_conv weight norm: weight = g * v / ||v|| with dim=2 (per
    kernel position), from weight_g / weight_v or the parametrizations
    layout; a plain weight as it is."""
    candidates = [
        (f"{base}.weight_g", f"{base}.weight_v"),
        (f"{base}.parametrizations.weight.original0",
         f"{base}.parametrizations.weight.original1"),
    ]
    for g_key, v_key in candidates:
        if g_key in sd:
            g = sd[g_key]  # (1, 1, K)
            v = sd[v_key]  # (out, in/groups, K)
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            return v * (g / np.maximum(norm, 1e-12))
    return sd[f"{base}.weight"]


def _is_fairseq_layout(sd) -> bool:
    """fairseq Wav2Vec2Model fingerprints (Sequential-index conv keys,
    post_extract_proj, self_attn block names), bare or under the w2v
    prefixes of fine-tuned fairseq CTC checkpoints."""
    for p in ("", "w2v_encoder.w2v_model.", "w2v_model.", "w2v_encoder."):
        if (f"{p}post_extract_proj.weight" in sd
                or f"{p}feature_extractor.conv_layers.0.0.weight" in sd
                or any(k.startswith(f"{p}encoder.layers.0.self_attn.")
                       for k in sd)):
            return True
    return False


def _fairseq_speech_encoder_tree(sd, cfg, num_layers=None):
    sd = _strip_prefix(sd, prefixes=("w2v_encoder.w2v_model.",
                                     "w2v_model.", "w2v_encoder."))
    n_layers = num_layers if num_layers is not None else cfg.num_layers
    conv_layers = []
    for i in range(len(cfg.conv_dims)):
        base = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": _jconv(sd, f"{base}.0")}
        if f"{base}.2.weight" in sd:        # Fp32GroupNorm (base, block 0)
            layer["norm"] = _ln(sd, f"{base}.2")
        elif f"{base}.2.1.weight" in sd:    # Fp32LayerNorm (large family)
            layer["norm"] = _ln(sd, f"{base}.2.1")
        conv_layers.append(layer)
    pos_w = _materialize_weight_norm(sd, "encoder.pos_conv.0")
    pos_conv = {"kernel": np.asarray(pos_w).transpose(2, 1, 0),
                "bias": np.asarray(sd["encoder.pos_conv.0.bias"])}

    def block(i):
        b = f"encoder.layers.{i}"
        return {
            "attention": {nm: _lin(sd, f"{b}.self_attn.{nm}") for nm in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "attention_layer_norm": _ln(sd, f"{b}.self_attn_layer_norm"),
            "ffn_in": _lin(sd, f"{b}.fc1"),
            "ffn_out": _lin(sd, f"{b}.fc2"),
            "final_layer_norm": _ln(sd, f"{b}.final_layer_norm"),
        }

    params = {
        "feature_extractor": {"layers": conv_layers},
        "feature_projection": {
            "layer_norm": _ln(sd, "layer_norm"),
            "projection": _lin(sd, "post_extract_proj"),
        },
        "pos_conv": pos_conv,
        "encoder_layer_norm": _ln(sd, "encoder.layer_norm"),
        "layers": _stack([block(i) for i in range(n_layers)]),
    }
    if "mask_emb" in sd:
        params["masked_spec_embed"] = np.asarray(sd["mask_emb"])
    return params


def _speech_encoder_tree(sd, cfg, num_layers=None):
    n_layers = num_layers if num_layers is not None else cfg.num_layers
    conv_layers = []
    for i in range(len(cfg.conv_dims)):
        base = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": _jconv(sd, f"{base}.conv")}
        if f"{base}.layer_norm.weight" in sd:
            layer["norm"] = _ln(sd, f"{base}.layer_norm")
        conv_layers.append(layer)
    pos_w = _materialize_weight_norm(sd, "encoder.pos_conv_embed.conv")
    pos_conv = {"kernel": np.asarray(pos_w).transpose(2, 1, 0),
                "bias": np.asarray(sd["encoder.pos_conv_embed.conv.bias"])}

    def block(i):
        b = f"encoder.layers.{i}"
        return {
            "attention": {nm: _lin(sd, f"{b}.attention.{nm}") for nm in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "attention_layer_norm": _ln(sd, f"{b}.layer_norm"),
            "ffn_in": _lin(sd, f"{b}.feed_forward.intermediate_dense"),
            "ffn_out": _lin(sd, f"{b}.feed_forward.output_dense"),
            "final_layer_norm": _ln(sd, f"{b}.final_layer_norm"),
        }

    params = {
        "feature_extractor": {"layers": conv_layers},
        "feature_projection": {
            "layer_norm": _ln(sd, "feature_projection.layer_norm"),
            "projection": _lin(sd, "feature_projection.projection"),
        },
        "pos_conv": pos_conv,
        "encoder_layer_norm": _ln(sd, "encoder.layer_norm"),
        "layers": _stack([block(i) for i in range(n_layers)]),
    }
    if "masked_spec_embed" in sd:
        params["masked_spec_embed"] = np.asarray(sd["masked_spec_embed"])
    return params


def load_speech_encoder(path: str, cfg, num_layers=None,
                        dtype=torch.float32, device="cpu"):
    """The port's speech-encoder parameters from a wav2vec2-family
    checkpoint, in the HF `transformers` layout or the fairseq / s3prl one
    (detected); `num_layers` keeps the bottom N transformer layers."""
    sd = _strip_prefix(load_state_dict(path))
    build = (_fairseq_speech_encoder_tree if _is_fairseq_layout(sd)
             else _speech_encoder_tree)
    return speech_encoder_from_jax(build(sd, cfg, num_layers), dtype, device)


def speech_encoder_from_state_dict(sd, cfg, num_layers=None,
                                   dtype=torch.float32, device="cpu"):
    """As load_speech_encoder, from a loaded, prefix-stripped HF-layout
    state dict (numpy arrays or tensors)."""
    return speech_encoder_from_jax(
        _speech_encoder_tree(_numpy_state_dict(sd), cfg, num_layers), dtype,
        device)


def speech_encoder_from_fairseq_state_dict(sd, cfg, num_layers=None,
                                           dtype=torch.float32,
                                           device="cpu"):
    """As load_speech_encoder, from a loaded fairseq-layout state dict (the
    s3prl hub format: Sequential-index convs, post_extract_proj, the
    weight-normed encoder.pos_conv.0, self_attn / fc1 / fc2 blocks,
    mask_emb; optionally under w2v prefixes)."""
    return speech_encoder_from_jax(_fairseq_speech_encoder_tree(
        _numpy_state_dict(sd), cfg, num_layers), dtype, device)


def _bart_block(sd, b, is_decoder):
    attn = lambda side: {nm: _lin(sd, f"{b}.{side}.{nm}") for nm in  # noqa
                         ("q_proj", "k_proj", "v_proj", "out_proj")}
    p = {
        "self_attn": attn("self_attn"),
        "self_attn_layer_norm": _ln(sd, f"{b}.self_attn_layer_norm"),
        "fc1": _lin(sd, f"{b}.fc1"),
        "fc2": _lin(sd, f"{b}.fc2"),
        "final_layer_norm": _ln(sd, f"{b}.final_layer_norm"),
    }
    if is_decoder:
        p["encoder_attn"] = attn("encoder_attn")
        p["encoder_attn_layer_norm"] = _ln(sd,
                                           f"{b}.encoder_attn_layer_norm")
    return p


def _t5_attn(sd, b):
    return {"q_proj": _lin(sd, f"{b}.q"), "k_proj": _lin(sd, f"{b}.k"),
            "v_proj": _lin(sd, f"{b}.v"), "out_proj": _lin(sd, f"{b}.o")}


def _t5_block(sd, b, is_decoder, gated):
    ff_idx = 2 if is_decoder else 1
    ff = f"{b}.layer.{ff_idx}.DenseReluDense"
    p = {
        "self_attn": _t5_attn(sd, f"{b}.layer.0.SelfAttention"),
        "self_attn_layer_norm": _rms(sd, f"{b}.layer.0.layer_norm"),
        "final_layer_norm": _rms(sd, f"{b}.layer.{ff_idx}.layer_norm"),
        "fc2": _lin(sd, f"{ff}.wo"),
    }
    if gated:
        p["fc_gate"] = _lin(sd, f"{ff}.wi_0")
        p["fc1"] = _lin(sd, f"{ff}.wi_1")
    else:
        p["fc1"] = _lin(sd, f"{ff}.wi")
    if is_decoder:
        p["encoder_attn"] = _t5_attn(sd, f"{b}.layer.1.EncDecAttention")
        p["encoder_attn_layer_norm"] = _rms(sd, f"{b}.layer.1.layer_norm")
    return p


def _seq2seq_tree(sd, cfg):
    params = {"shared": {"embedding": np.asarray(sd["shared.weight"])}}
    if cfg.arch == "bart":
        sides = {}
        for side in ("encoder", "decoder"):
            sides[side] = {
                "embed_positions": {"embedding": np.asarray(
                    sd[f"{side}.embed_positions.weight"])},
                "layernorm_embedding": _ln(sd, f"{side}.layernorm_embedding"),
                "layers": _stack([
                    _bart_block(sd, f"{side}.layers.{i}", side == "decoder")
                    for i in range(cfg.encoder_layers if side == "encoder"
                                   else cfg.decoder_layers)]),
            }
        flb = sd.get("final_logits_bias",
                     np.zeros((1, cfg.vocab_size), np.float32))
        params["final_logits_bias"] = np.asarray(flb).reshape(-1)
    else:
        gated = cfg.activation == "gelu_gated"
        sides = {}
        for side in ("encoder", "decoder"):
            sides[side] = {
                "rel_bias": {"embedding": np.asarray(
                    sd[f"{side}.block.0.layer.0.SelfAttention"
                       ".relative_attention_bias.weight"])},
                "final_layer_norm": _rms(sd, f"{side}.final_layer_norm"),
                "layers": _stack([
                    _t5_block(sd, f"{side}.block.{i}", side == "decoder",
                              gated)
                    for i in range(cfg.encoder_layers if side == "encoder"
                                   else cfg.decoder_layers)]),
            }
    params.update(sides)
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": np.asarray(sd["lm_head.weight"]).T}
    return params


def load_seq2seq(path: str, cfg, dtype=torch.float32, device="cpu"):
    """The port's BART / T5 / ByT5 parameters from an HF checkpoint."""
    return seq2seq_from_state_dict(_strip_prefix(load_state_dict(path)), cfg,
                                   dtype, device)


def seq2seq_from_state_dict(sd, cfg, dtype=torch.float32, device="cpu"):
    """As load_seq2seq, from a loaded, prefix-stripped state dict."""
    return seq2seq_from_jax(_seq2seq_tree(_numpy_state_dict(sd), cfg), dtype,
                            device)


def _speechmix_tree(sd, cfg: SpeechMixConfig):
    def sub(prefix):
        n = len(prefix)
        return _strip_prefix({k[n:]: v for k, v in sd.items()
                              if k.startswith(prefix)})

    params = {
        "speech_encoder": _speech_encoder_tree(
            sub("encoder_model."), cfg.encoder,
            cfg.num_speech_encoder_layers),
        "nlp": _seq2seq_tree(sub("decoder_model."), cfg.decoder),
        "enc_to_dec_proj": _lin(sd, "enc_to_dec_proj"),
        "length_adapter": [_jconv(sd, f"length_adapters.{i}")
                           for i in range(cfg.downloop)],
    }
    if cfg.weighted_sum:
        params["weights_sum"] = (
            np.asarray(sd["weights_sum"]) if "weights_sum" in sd
            else np.zeros((cfg.num_weighted_sum,), np.float32))
    if cfg.variant == "gan" and "discriminator.weight" in sd:
        params["discriminator"] = _lin(sd, "discriminator")
    if "adapters.0.0.weight" in sd:
        # one LN -> down -> ReLU -> up Sequential per NLP layer, the encoder
        # layers first (Sequential indices 0 / 1 / 3)
        def adapter(i):
            return {"layer_norm": _ln(sd, f"adapters.{i}.0"),
                    "down": _lin(sd, f"adapters.{i}.1"),
                    "up": _lin(sd, f"adapters.{i}.3")}
        enc_n = cfg.decoder.encoder_layers
        params["adapters"] = {
            "encoder": _stack([adapter(i) for i in range(enc_n)]),
            "decoder": _stack([adapter(enc_n + i)
                               for i in range(cfg.decoder.decoder_layers)]),
        }
    return params


def load_speechmix(sd_or_path, cfg: SpeechMixConfig, dtype=torch.float32,
                   device="cpu"):
    """The port's parameters from a whole reference HFSpeechMixEED-family
    state dict (a path, or a dict of tensors or numpy arrays):
    encoder_model.* -> speech_encoder (at cfg.num_speech_encoder_layers, the
    depth the reference saves), decoder_model.* -> nlp, length_adapters.{i}
    -> length_adapter, enc_to_dec_proj, weights_sum (zeros when absent),
    the gan variant's discriminator and the adapters (adapters.{i}.0/1/3)
    when present."""
    sd = (_numpy_state_dict(sd_or_path) if isinstance(sd_or_path, dict)
          else load_state_dict(sd_or_path))
    return params_from_jax(_speechmix_tree(sd, cfg), cfg, dtype, device)


def _bart_block_zeros(dec_cfg):
    h, f = dec_cfg.hidden_size, dec_cfg.ffn_dim

    def lin(i, o):
        return {"kernel": np.zeros((i, o), np.float32),
                "bias": np.zeros((o,), np.float32)}

    def ln():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    return {
        "self_attn": {"q_proj": lin(h, h), "k_proj": lin(h, h),
                      "v_proj": lin(h, h), "out_proj": lin(h, h)},
        "self_attn_layer_norm": ln(),
        "fc1": lin(h, f), "fc2": lin(f, h), "final_layer_norm": ln(),
    }


def load_speechmix_ed(sd_or_path, cfg: SpeechMixConfig, dtype=torch.float32,
                      device="cpu"):
    """The port's ``ed``-variant parameters from a reference HFSpeechMixED
    state dict (SpeechEncoderDecoderModel: model.encoder.* a Wav2Vec2Model,
    model.decoder.* a BartForCausalLM, optional model.enc_to_dec_proj.*).
    No length adapters or weighted sum; without enc_to_dec_proj (equal
    hidden sizes) an identity projection; the text-encoder subtree, which
    the ed forward never runs, zero-filled."""
    sd = (_numpy_state_dict(sd_or_path) if isinstance(sd_or_path, dict)
          else load_state_dict(sd_or_path))
    if any(k.startswith("model.encoder.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    enc_sd = _strip_prefix({k[len("encoder."):]: v for k, v in sd.items()
                            if k.startswith("encoder.")})
    speech = _speech_encoder_tree(enc_sd, cfg.encoder,
                                  cfg.num_speech_encoder_layers)
    # BartForCausalLM nests the decoder under decoder.model.decoder.*
    dsd = {}
    for k, v in sd.items():
        if k.startswith("decoder.model.decoder."):
            dsd["decoder." + k[len("decoder.model.decoder."):]] = v
        elif k == "decoder.lm_head.weight":
            dsd["lm_head.weight"] = v
    dec_cfg = cfg.decoder
    h = dec_cfg.hidden_size
    nlp = {
        "shared": {"embedding": np.asarray(
            dsd["decoder.embed_tokens.weight"])},
        "final_logits_bias": np.zeros((dec_cfg.vocab_size,), np.float32),
        "decoder": {
            "embed_positions": {"embedding": np.asarray(
                dsd["decoder.embed_positions.weight"])},
            "layernorm_embedding": _ln(dsd, "decoder.layernorm_embedding"),
            "layers": _stack([_bart_block(dsd, f"decoder.layers.{i}", True)
                              for i in range(dec_cfg.decoder_layers)]),
        },
        "encoder": {
            "embed_positions": {"embedding": np.zeros(
                (dec_cfg.max_positions + 2, h), np.float32)},
            "layernorm_embedding": {"scale": np.ones((h,), np.float32),
                                    "bias": np.zeros((h,), np.float32)},
            "layers": _stack([_bart_block_zeros(dec_cfg)
                              for _ in range(dec_cfg.encoder_layers)]),
        },
    }
    if not dec_cfg.tie_word_embeddings and "lm_head.weight" in dsd:
        nlp["lm_head"] = {"kernel": np.asarray(dsd["lm_head.weight"]).T}
    if "enc_to_dec_proj.weight" in sd:
        proj = _lin(sd, "enc_to_dec_proj")
    else:
        if cfg.encoder.hidden_size != h:
            raise ValueError("checkpoint has no enc_to_dec_proj but the "
                             "hidden sizes differ")
        proj = {"kernel": np.eye(h, dtype=np.float32),
                "bias": np.zeros((h,), np.float32)}
    tree = {"speech_encoder": speech, "nlp": nlp, "enc_to_dec_proj": proj,
            "length_adapter": []}
    return params_from_jax(tree, cfg, dtype, device)


# ----------------------------------------------------------------------------
# export: the port's parameters -> a reference-format state dict
# ----------------------------------------------------------------------------

def _exp_lin(out, p, name):
    out[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _exp_ln(out, p, name):
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _exp_rms(out, p, name):
    out[f"{name}.weight"] = np.asarray(p["scale"])


def _exp_conv(out, p, name):
    out[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(2, 1, 0)
    if "bias" in p:
        out[f"{name}.bias"] = np.asarray(p["bias"])


def _layers(stacked):
    """The per-layer trees of a stacked JAX-layout tree."""
    leaves = [leaf for _, leaf in flatten_with_paths(stacked)]
    n = leaves[0].shape[0]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i]
    return [take(stacked, i) for i in range(n)]


def _export_speech_encoder(out, params, prefix):
    if "masked_spec_embed" in params:
        out[f"{prefix}masked_spec_embed"] = np.asarray(
            params["masked_spec_embed"])
    else:
        # a zeros vector, so that the reference's strict load_state_dict
        # succeeds (it reads it only when SpecAugment masks in training)
        hidden = params["feature_projection"]["projection"]["kernel"].shape[1]
        out[f"{prefix}masked_spec_embed"] = np.zeros((hidden,), np.float32)
    for i, layer in enumerate(params["feature_extractor"]["layers"]):
        base = f"{prefix}feature_extractor.conv_layers.{i}"
        _exp_conv(out, layer["conv"], f"{base}.conv")
        if "norm" in layer:
            _exp_ln(out, layer["norm"], f"{base}.layer_norm")
    fp = params["feature_projection"]
    _exp_ln(out, fp["layer_norm"], f"{prefix}feature_projection.layer_norm")
    _exp_lin(out, fp["projection"], f"{prefix}feature_projection.projection")
    # the positional conv's weight norm: v = w, g = ||w|| over (out, in) per
    # kernel position, which _materialize_weight_norm turns back into w;
    # summed over the contiguous JAX layout, as the JAX package sums it
    w = np.ascontiguousarray(params["pos_conv"]["kernel"]).transpose(2, 1, 0)
    g = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
    base = f"{prefix}encoder.pos_conv_embed.conv"
    out[f"{base}.weight_g"] = g
    out[f"{base}.weight_v"] = w
    out[f"{base}.bias"] = np.asarray(params["pos_conv"]["bias"])
    _exp_ln(out, params["encoder_layer_norm"], f"{prefix}encoder.layer_norm")
    for i, blk in enumerate(_layers(params["layers"])):
        b = f"{prefix}encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _exp_lin(out, blk["attention"][nm], f"{b}.attention.{nm}")
        _exp_ln(out, blk["attention_layer_norm"], f"{b}.layer_norm")
        _exp_lin(out, blk["ffn_in"], f"{b}.feed_forward.intermediate_dense")
        _exp_lin(out, blk["ffn_out"], f"{b}.feed_forward.output_dense")
        _exp_ln(out, blk["final_layer_norm"], f"{b}.final_layer_norm")


def _export_bart_block(out, blk, b, is_decoder):
    for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _exp_lin(out, blk["self_attn"][nm], f"{b}.self_attn.{nm}")
    _exp_ln(out, blk["self_attn_layer_norm"], f"{b}.self_attn_layer_norm")
    _exp_lin(out, blk["fc1"], f"{b}.fc1")
    _exp_lin(out, blk["fc2"], f"{b}.fc2")
    _exp_ln(out, blk["final_layer_norm"], f"{b}.final_layer_norm")
    if is_decoder:
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _exp_lin(out, blk["encoder_attn"][nm], f"{b}.encoder_attn.{nm}")
        _exp_ln(out, blk["encoder_attn_layer_norm"],
                f"{b}.encoder_attn_layer_norm")


_T5_NAMES = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
             ("out_proj", "o"))


def _export_t5_block(out, blk, b, is_decoder, gated):
    for ours, theirs in _T5_NAMES:
        _exp_lin(out, blk["self_attn"][ours],
                 f"{b}.layer.0.SelfAttention.{theirs}")
    _exp_rms(out, blk["self_attn_layer_norm"], f"{b}.layer.0.layer_norm")
    ff_idx = 2 if is_decoder else 1
    ff = f"{b}.layer.{ff_idx}.DenseReluDense"
    if gated:
        _exp_lin(out, blk["fc_gate"], f"{ff}.wi_0")
        _exp_lin(out, blk["fc1"], f"{ff}.wi_1")
    else:
        _exp_lin(out, blk["fc1"], f"{ff}.wi")
    _exp_lin(out, blk["fc2"], f"{ff}.wo")
    _exp_rms(out, blk["final_layer_norm"], f"{b}.layer.{ff_idx}.layer_norm")
    if is_decoder:
        for ours, theirs in _T5_NAMES:
            _exp_lin(out, blk["encoder_attn"][ours],
                     f"{b}.layer.1.EncDecAttention.{theirs}")
        _exp_rms(out, blk["encoder_attn_layer_norm"],
                 f"{b}.layer.1.layer_norm")


def _export_seq2seq(out, params, cfg, prefix):
    shared = np.asarray(params["shared"]["embedding"])
    if cfg.arch == "bart":
        m = f"{prefix}model."
        out[f"{m}shared.weight"] = shared
        # the tied aliases torch's state_dict() also carries
        out[f"{m}encoder.embed_tokens.weight"] = shared
        out[f"{m}decoder.embed_tokens.weight"] = shared
        for side in ("encoder", "decoder"):
            p = params[side]
            out[f"{m}{side}.embed_positions.weight"] = np.asarray(
                p["embed_positions"]["embedding"])
            _exp_ln(out, p["layernorm_embedding"],
                    f"{m}{side}.layernorm_embedding")
            for i, blk in enumerate(_layers(p["layers"])):
                _export_bart_block(out, blk, f"{m}{side}.layers.{i}",
                                   side == "decoder")
        out[f"{prefix}final_logits_bias"] = np.asarray(
            params["final_logits_bias"]).reshape(1, -1)
    else:
        out[f"{prefix}shared.weight"] = shared
        out[f"{prefix}encoder.embed_tokens.weight"] = shared
        out[f"{prefix}decoder.embed_tokens.weight"] = shared
        gated = cfg.activation == "gelu_gated"
        for side in ("encoder", "decoder"):
            p = params[side]
            out[f"{prefix}{side}.block.0.layer.0.SelfAttention"
                f".relative_attention_bias.weight"] = np.asarray(
                    p["rel_bias"]["embedding"])
            _exp_rms(out, p["final_layer_norm"],
                     f"{prefix}{side}.final_layer_norm")
            for i, blk in enumerate(_layers(p["layers"])):
                _export_t5_block(out, blk, f"{prefix}{side}.block.{i}",
                                 side == "decoder", gated)
    if cfg.tie_word_embeddings:
        out[f"{prefix}lm_head.weight"] = shared
    elif "lm_head" in params:
        out[f"{prefix}lm_head.weight"] = np.asarray(
            params["lm_head"]["kernel"]).T


def export_speechmix(params, cfg: SpeechMixConfig):
    """The inverse of load_speechmix: the port's parameters (float; any
    device) as a reference-format HFSpeechMixEED state dict of float32
    numpy arrays under the torch key names, which the reference model loads
    and load_speechmix reads back (the JAX package's export_speechmix of
    the same weights)."""
    tree = tree_to_jax_layout(params)
    out = {}
    _export_speech_encoder(out, tree["speech_encoder"], "encoder_model.")
    _export_seq2seq(out, tree["nlp"], cfg.decoder, "decoder_model.")
    # the reference registers the tied NLP input embedding as nlp_emb
    out["nlp_emb.weight"] = np.asarray(tree["nlp"]["shared"]["embedding"])
    _exp_lin(out, tree["enc_to_dec_proj"], "enc_to_dec_proj")
    for i, conv in enumerate(tree["length_adapter"]):
        _exp_conv(out, conv, f"length_adapters.{i}")
    if "weights_sum" in tree:
        out["weights_sum"] = np.asarray(tree["weights_sum"])
    if "discriminator" in tree:
        _exp_lin(out, tree["discriminator"], "discriminator")
    if "adapters" in tree:
        ads = (_layers(tree["adapters"]["encoder"]) +
               _layers(tree["adapters"]["decoder"]))
        for i, ad in enumerate(ads):
            _exp_ln(out, ad["layer_norm"], f"adapters.{i}.0")
            _exp_lin(out, ad["down"], f"adapters.{i}.1")
            _exp_lin(out, ad["up"], f"adapters.{i}.3")
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


# ----------------------------------------------------------------------------
# configurations from an HF config.json
# ----------------------------------------------------------------------------

_SPEECH_MODEL_TYPES = ("wav2vec2", "hubert", "unispeech-sat", "unispeech_sat")
_SEQ2SEQ_MODEL_TYPES = ("bart", "mbart", "t5", "mt5", "byt5")


def _encoder_config_from_dict(d: dict):
    """An HF Wav2Vec2Config / HubertConfig / UniSpeechSatConfig dict as a
    SpeechEncoderConfig."""
    from .config import SpeechEncoderConfig
    return SpeechEncoderConfig(
        name=d.get("_name_or_path") or d.get("model_type", "wav2vec2"),
        conv_dims=tuple(d.get("conv_dim", (512,) * 7)),
        conv_kernels=tuple(d.get("conv_kernel", (10, 3, 3, 3, 3, 2, 2))),
        conv_strides=tuple(d.get("conv_stride", (5, 2, 2, 2, 2, 2, 2))),
        conv_bias=bool(d.get("conv_bias", False)),
        feat_extract_norm=d.get("feat_extract_norm", "group"),
        hidden_size=int(d.get("hidden_size", 768)),
        num_layers=int(d.get("num_hidden_layers", 12)),
        num_heads=int(d.get("num_attention_heads", 12)),
        ffn_dim=int(d.get("intermediate_size", 3072)),
        activation=d.get("hidden_act", "gelu"),
        layer_norm_eps=float(d.get("layer_norm_eps", 1e-5)),
        do_stable_layer_norm=bool(d.get("do_stable_layer_norm", False)),
        pos_conv_kernel=int(d.get("num_conv_pos_embeddings", 128)),
        pos_conv_groups=int(d.get("num_conv_pos_embedding_groups", 16)),
        dropout=float(d.get("hidden_dropout", 0.1)),
        attention_dropout=float(d.get("attention_dropout", 0.1)),
        activation_dropout=float(d.get("activation_dropout", 0.1)),
        feat_proj_dropout=float(d.get("feat_proj_dropout", 0.1)),
        apply_spec_augment=bool(d.get("apply_spec_augment", True)),
        mask_time_prob=float(d.get("mask_time_prob", 0.05)),
        mask_time_length=int(d.get("mask_time_length", 10)),
        mask_time_min_masks=int(d.get("mask_time_min_masks", 2)),
        mask_feature_prob=float(d.get("mask_feature_prob", 0.0)),
        mask_feature_length=int(d.get("mask_feature_length", 10)),
        mask_feature_min_masks=int(d.get("mask_feature_min_masks", 0)),
        layerdrop=float(d.get("layerdrop", 0.1)),
    )


def _id_or(d: dict, key: str, default):
    """A token id that HF may serialize as JSON null; 0 is a valid id."""
    v = d.get(key)
    return int(default if v is None else v)


def _seq2seq_config_from_dict(d: dict):
    """An HF BartConfig / T5Config dict as a Seq2SeqConfig."""
    from .config import Seq2SeqConfig
    mt = d.get("model_type", "bart")
    name = d.get("_name_or_path") or mt
    if mt in ("t5", "mt5", "byt5"):
        ff_proj = d.get("feed_forward_proj", "relu")
        gated = ff_proj.startswith("gated-")
        act = ff_proj[len("gated-"):] if gated else ff_proj
        if gated:
            act = act + "_gated"
        return Seq2SeqConfig(
            name=name, arch="t5",
            vocab_size=int(d.get("vocab_size", 32128)),
            hidden_size=int(d.get("d_model", 512)),
            encoder_layers=int(d.get("num_layers", 6)),
            decoder_layers=int(d.get("num_decoder_layers",
                                     d.get("num_layers", 6))),
            num_heads=int(d.get("num_heads", 8)),
            head_dim=int(d.get("d_kv", 64)),
            ffn_dim=int(d.get("d_ff", 2048)),
            activation=act,
            layer_norm_eps=float(d.get("layer_norm_epsilon", 1e-6)),
            dropout=float(d.get("dropout_rate", 0.1)),
            attention_dropout=float(d.get("dropout_rate", 0.1)),
            activation_dropout=float(d.get("dropout_rate", 0.1)),
            scale_embedding=False,
            tie_word_embeddings=bool(d.get("tie_word_embeddings", True)),
            pad_token_id=_id_or(d, "pad_token_id", 0),
            bos_token_id=_id_or(d, "bos_token_id", 0),
            eos_token_id=_id_or(d, "eos_token_id", 1),
            decoder_start_token_id=_id_or(
                d, "decoder_start_token_id", _id_or(d, "pad_token_id", 0)),
            relative_attention_num_buckets=int(
                d.get("relative_attention_num_buckets", 32)),
            relative_attention_max_distance=int(
                d.get("relative_attention_max_distance", 128)),
            max_length=int(d.get("max_length") or 128),
        )
    enc_heads = int(d.get("encoder_attention_heads", 12))
    dec_heads = int(d.get("decoder_attention_heads", enc_heads))
    enc_ffn = int(d.get("encoder_ffn_dim", 3072))
    dec_ffn = int(d.get("decoder_ffn_dim", enc_ffn))
    if dec_heads != enc_heads or dec_ffn != enc_ffn:
        # one num_heads / ffn_dim for both stacks
        raise ValueError(
            f"asymmetric BART checkpoint not representable: encoder "
            f"heads/ffn {enc_heads}/{enc_ffn} vs decoder "
            f"{dec_heads}/{dec_ffn}")
    return Seq2SeqConfig(
        name=name, arch="bart",
        vocab_size=int(d.get("vocab_size", 50265)),
        hidden_size=int(d.get("d_model", 768)),
        encoder_layers=int(d.get("encoder_layers", 6)),
        decoder_layers=int(d.get("decoder_layers", 6)),
        num_heads=enc_heads,
        ffn_dim=enc_ffn,
        activation=d.get("activation_function", "gelu"),
        max_positions=int(d.get("max_position_embeddings", 1024)),
        dropout=float(d.get("dropout", 0.1)),
        attention_dropout=float(d.get("attention_dropout", 0.1)),
        activation_dropout=float(d.get("activation_dropout", 0.1)),
        scale_embedding=bool(d.get("scale_embedding", False)),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", True)),
        pad_token_id=_id_or(d, "pad_token_id", 1),
        bos_token_id=_id_or(d, "bos_token_id", 0),
        eos_token_id=_id_or(d, "eos_token_id", 2),
        decoder_start_token_id=_id_or(d, "decoder_start_token_id", 2),
        max_length=int(d.get("max_length") or 128),
    )


# The fields of facebook/wav2vec2-xls-r-1b's published config.json that fix
# its shapes: 48 pre-LN layers of H = 1280 with 16 heads of 80 and
# F = 5120, seven 512-channel extractor layers each with a LayerNorm (the
# widths of facebook/hubert-xlarge-ll60k too).  config_from_hf takes it like
# a checkpoint's config.json; the other fields keep their HF defaults.
XLS_R_1B_CONFIG = {
    "_name_or_path": "facebook/wav2vec2-xls-r-1b",
    "model_type": "wav2vec2",
    "hidden_size": 1280,
    "num_hidden_layers": 48,
    "num_attention_heads": 16,
    "intermediate_size": 5120,
    "conv_dim": [512, 512, 512, 512, 512, 512, 512],
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
    "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "feat_extract_norm": "layer",
    "conv_bias": True,
    "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16,
    "hidden_act": "gelu",
}


def config_from_hf(path_or_dict):
    """The port's configuration from an HF checkpoint's config.json (a
    checkpoint directory, the file, or the parsed dict): a
    SpeechEncoderConfig for wav2vec2 / hubert / unispeech-sat, a
    Seq2SeqConfig for the bart / t5 family, or (SpeechEncoderConfig,
    Seq2SeqConfig) for the reference's composite config ("model_type":
    "speechmix", or "encoder" and "decoder" dicts).  The fusion
    hyperparameters (share_layer_ratio, down_scale, ...) are not stored
    there: the model constructor takes them.  A sibling
    generation_config.json's max_length overrides the config's."""
    gen_cfg = None
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        p = str(path_or_dict)
        if os.path.isdir(p):
            gen_p = os.path.join(p, "generation_config.json")
            if os.path.exists(gen_p):
                with open(gen_p) as f:
                    gen_cfg = json.load(f)
            p = os.path.join(p, "config.json")
        with open(p) as f:
            d = json.load(f)

    def gen_max_length(cfg):
        if gen_cfg and gen_cfg.get("max_length"):
            return dataclasses.replace(cfg,
                                       max_length=int(gen_cfg["max_length"]))
        return cfg

    mt = d.get("model_type", "")
    if mt == "speechmix" or ("encoder" in d and "decoder" in d and
                             isinstance(d.get("encoder"), dict)):
        return (_encoder_config_from_dict(d["encoder"]),
                gen_max_length(_seq2seq_config_from_dict(d["decoder"])))
    if mt in _SPEECH_MODEL_TYPES or "conv_dim" in d:
        return _encoder_config_from_dict(d)
    if mt in _SEQ2SEQ_MODEL_TYPES or "d_model" in d:
        return gen_max_length(_seq2seq_config_from_dict(d))
    raise ValueError(f"unrecognized HF config (model_type={mt!r})")
