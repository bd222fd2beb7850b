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
  encoder's entries (HF's registration order).

``tree_to_jax_layout`` walks the other way, for a tree shaped like the
port's parameters (the parameters themselves, or their gradients): numpy
arrays in the JAX package's layout, layer lists stacked again.
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
    return out


def cross_kv_from_jax(a, device="cpu"):
    """A cross K or V array of the JAX package's decoder cache, stored
    batch-minor (L, T_enc, H, D, B) in the compute dtype or as int8 codes,
    in the port's (L, B, T_enc, H, D) layout.  (The scales are (L, B, T_enc,
    H) in both packages.)"""
    return torch.tensor(np.ascontiguousarray(
        np.asarray(a).transpose(0, 4, 1, 2, 3)), device=device)


def _stack(layer_list):
    first = layer_list[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layer_list]) for k in first}
    return np.stack([_numpy(t) for t in layer_list])


def _numpy(t):
    return t.detach().float().cpu().numpy()


def _to_jax(tree, path=()):
    if isinstance(tree, dict):
        if "kernel" in tree and tree["kernel"].ndim == 3:   # a convolution
            out = {k: _numpy(v) for k, v in tree.items()}
            out["kernel"] = out["kernel"].transpose(2, 1, 0)
            return out
        return {k: (_stack(v) if k == "layers" and path[-1:] != (
            "feature_extractor",) else _to_jax(v, path + (k,)))
            for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_jax(v, path) for v in tree]
    return _numpy(tree)


def tree_to_jax_layout(tree):
    """The inverse walk of params_from_jax for a tree shaped like the port's
    parameters (parameters or gradients): float32 numpy arrays, the three
    transformer layer lists stacked on a leading axis, conv kernels as
    (K, C_in, C_out)."""
    return _to_jax(tree)
