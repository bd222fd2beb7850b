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
tensors it is made of (the optimizer's view of the JAX layout), and
``adafactor_state_to_jax`` the port's Adafactor statistics in the layout of
optax's ``FactoredState``.
"""

from __future__ import annotations

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


def adafactor_state_to_jax(opt_state):
    """The port's Adafactor state as optax's FactoredState holds it for the
    JAX tree of the same parameters: {"count", "v_row", "v_col", "v"}, each
    statistics tree in the JAX layout (which the port's Adafactor keeps)
    with float32 numpy leaves; a leaf's unused statistics are zeros of
    shape (1,), as in optax."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _numpy(t)
    return {"count": opt_state["count"],
            **{k: walk(opt_state[k]) for k in ("v_row", "v_col", "v")}}
