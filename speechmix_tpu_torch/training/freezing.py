"""Parameter freezing as masks over the parameter tree (port of
``speechmix_tpu.training.freezing``).

A mask is a tree shaped like the parameters whose leaves are the Python
floats 0.0 (frozen) or 1.0 (trainable); ``apply_grad_mask`` multiplies
gradients by masks.  (The train step multiplies its masks together and
computes no gradient where the product is 0, which gives the same zero.)
Paths are the '/'-joined keys and
list indices from the root ("nlp/decoder/layers/3/fc1/kernel"; the JAX
package stacks the layers and has no index there, which no predicate reads).
Trees are walked in insertion order, which the model initialisers and
``convert.params_from_jax`` keep to HF's registration order: the speech
encoder's ``masked_spec_embed`` first, then the extractor, as the JAX
package's tensor ranking orders them (its freezing.py, ``_PRE_GROUPS``).

Three kinds of mask act on the gradients: the variant's static mask
(``variant_trainable_mask``), gradual unfreezing of the speech encoder
(``reference_unfreeze_scale``, tensor granularity, the default, or
``gradual_unfreeze_scale``, layer granularity) and the GAN's alternating
generator / discriminator masks (``gan_alternating_masks``).  Since the
port's layers are separate leaves, every leaf of every mask is one number;
where the JAX package has a stacked (L, ...) mask, the port has L per-layer
scalars.  The thresholds are compared in float32, as the JAX package
compares them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..config import SpeechMixConfig

SEP = "/"


def tree_map_with_path(fn, tree, prefix=""):
    """A tree of fn(path, leaf) shaped like `tree` (dicts and lists)."""
    join = lambda key: f"{prefix}{SEP}{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, join(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_paths(tree):
    """Flatten to [(path, leaf)], dict keys in insertion order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def mask_from_predicate(params, predicate: Callable[[str], bool]):
    """A {0.0, 1.0} mask tree from a predicate on the parameter's path."""
    return tree_map_with_path(
        lambda path, _: 1.0 if predicate(path) else 0.0, params)


def fixed_parameters_mask(params, fixed_except: Sequence[str]):
    """The `fixed_parameters=True` policy: within the speech encoder and the
    NLP model a parameter is trainable iff its path contains one of the
    fixed_except substrings; the bridge (weights_sum, length_adapter,
    enc_to_dec_proj) lies outside both and stays trainable."""
    def pred(path):
        if not (path.startswith("speech_encoder") or path.startswith("nlp")):
            return True
        return any(s in path for s in fixed_except)
    return mask_from_predicate(params, pred)


def variant_trainable_mask(params, cfg: SpeechMixConfig, fixed_speech=False,
                           fixed_nlp=True):
    """Static trainable mask of each variant:

    eed:     everything trainable;
    ed:      everything except the conv feature extractor;
    fixed:   the speech encoder and / or the NLP model frozen per flag;
    adapter: the NLP encoder and decoder layers frozen, the adapters, the
             embeddings and the bridge trainable;
    self:    the NLP model frozen;
    gan:     the NLP model frozen (the discriminator trains; see
             gan_alternating_masks for which steps).

    With cfg.fixed_parameters the fixed_parameters_mask multiplies in."""
    v = cfg.variant

    def pred(path):
        if v == "ed":
            return not path.startswith(
                f"speech_encoder{SEP}feature_extractor")
        if v == "fixed":
            if path.startswith("speech_encoder") and fixed_speech:
                return False
            if path.startswith("nlp") and fixed_nlp:
                return False
        if v == "adapter":
            return not (path.startswith(f"nlp{SEP}encoder{SEP}layers") or
                        path.startswith(f"nlp{SEP}decoder{SEP}layers"))
        if v in ("self", "gan"):
            return not path.startswith("nlp")
        return True

    mask = mask_from_predicate(params, pred)
    if cfg.fixed_parameters:
        fixed = fixed_parameters_mask(params, cfg.fixed_except)
        mask = tree_map(lambda a, b: a * b, mask, fixed)
    return mask


def gan_alternating_masks(params, step: int, des_update: int):
    """The GAN's alternating updates: in block step // des_update, even
    blocks train the generator (everything but the discriminator), odd
    blocks only the discriminator."""
    disc_block = (step // des_update) % 2 == 1
    return mask_from_predicate(
        params, lambda path: path.startswith("discriminator") == disc_block)


def _speech_layers(params):
    enc = params.get("speech_encoder") if isinstance(params, dict) else None
    return len(enc["layers"]) if enc is not None else 0


def _layer_index(path, prefix):
    """The layer index of a path under `prefix` + "layers/", else None."""
    head = f"{prefix}layers{SEP}"
    if not path.startswith(head):
        return None
    return int(path[len(head):].split(SEP, 1)[0])


def gradual_unfreeze_scale(params, progress):
    """Layer-granularity gradual unfreezing of the speech encoder (the JAX
    package's gradual_unfreeze_scale).  progress = epoch / freeze_epochs
    (>= 1 after the window): transformer layer l of L trains when progress
    > (L - l) / (L + 1), so the top layer is released first; the encoder's
    other parameters train only at progress >= 1.  1.0 outside the speech
    encoder."""
    n_layers = _speech_layers(params)
    progress = np.float32(progress)
    prefix = f"speech_encoder{SEP}"

    def scale(path):
        if not path.startswith("speech_encoder"):
            return True
        layer = _layer_index(path, prefix)
        if layer is not None:
            return bool(progress > np.float32(n_layers - layer)
                        / np.float32(n_layers + 1))
        return bool(progress >= np.float32(1.0))
    return mask_from_predicate(params, scale)


# HF Wav2Vec2EncoderLayer's parameter registration order: the in-layer
# tensor sequence the reference's FreezingCallback walks
_INLAYER_ORDER = (
    "attention/k_proj/kernel", "attention/k_proj/bias",
    "attention/v_proj/kernel", "attention/v_proj/bias",
    "attention/q_proj/kernel", "attention/q_proj/bias",
    "attention/out_proj/kernel", "attention/out_proj/bias",
    "attention_layer_norm/scale", "attention_layer_norm/bias",
    "ffn_in/kernel", "ffn_in/bias",
    "ffn_out/kernel", "ffn_out/bias",
    "final_layer_norm/scale", "final_layer_norm/bias",
)

# the groups before the transformer layers, in Wav2Vec2Model's registration
# order, after masked_spec_embed and the extractor's layers; the pre-LN
# tree's encoder LayerNorm also ranks after the positional conv
_PRE_GROUPS = (
    ("feature_projection/layer_norm/scale",
     "feature_projection/layer_norm/bias",
     "feature_projection/projection/kernel",
     "feature_projection/projection/bias"),
    ("pos_conv/bias", "pos_conv/kernel"),
    ("encoder_layer_norm/scale", "encoder_layer_norm/bias"),
)


def _encoder_tensor_ranks(enc_params):
    """The registration rank of every speech-encoder leaf (the order of
    torch's named_parameters that the reference's FreezingCallback walks):
    ({path within the encoder: rank}, n_total).  A transformer-layer leaf
    "layers/l/<name>" has rank base + l * 16 + (the name's place in
    _INLAYER_ORDER); n_total counts 16 tensors per layer."""
    paths = {path for path, _ in tree_paths(enc_params)}
    order = ["masked_spec_embed"] if "masked_spec_embed" in paths else []
    i = 0
    while f"feature_extractor/layers/{i}/conv/kernel" in paths:
        order += [t for t in (f"feature_extractor/layers/{i}/conv/kernel",
                              f"feature_extractor/layers/{i}/conv/bias",
                              f"feature_extractor/layers/{i}/norm/scale",
                              f"feature_extractor/layers/{i}/norm/bias")
                  if t in paths]
        i += 1
    for group in _PRE_GROUPS:
        order += [t for t in group if t in paths]
    base = len(order)
    ranks = {p: r for r, p in enumerate(order)}
    n_layers = len(enc_params["layers"])
    for layer in range(n_layers):
        for t_idx, name in enumerate(_INLAYER_ORDER):
            p = f"layers{SEP}{layer}{SEP}{name}"
            if p in paths:
                ranks[p] = base + layer * len(_INLAYER_ORDER) + t_idx
    return ranks, base + n_layers * len(_INLAYER_ORDER)


def reference_unfreeze_scale(params, epoch, freeze_epoch: int):
    """Tensor-granularity gradual unfreezing, the reference's
    FreezingCallback (the JAX package's reference_unfreeze_scale): at the
    start of epoch e < freeze_epoch the last int(n / freeze_epoch) * e
    tensors of the speech encoder's registration order train, top layer
    first; epoch 0 (the slice [-0:]) and every epoch from freeze_epoch on
    train everything.  A fractional epoch acts as its floor.  1.0 outside
    the speech encoder."""
    enc = params.get("speech_encoder") if isinstance(params, dict) else None
    if enc is None:
        return mask_from_predicate(params, lambda path: True)
    ranks, n_total = _encoder_tensor_ranks(enc)
    freeze_tensors = int(n_total / freeze_epoch) if freeze_epoch > 0 else 0
    epoch = np.float32(epoch)
    k = np.float32(freeze_tensors) * np.floor(epoch)
    release_all = bool(epoch >= freeze_epoch) or bool(k < 1)
    prefix = f"speech_encoder{SEP}"

    def trainable(path):
        rank = (ranks.get(path[len(prefix):])
                if path.startswith(prefix) else None)
        if rank is None or release_all:
            return True
        return bool(np.float32(rank) >= np.float32(n_total) - k)
    return mask_from_predicate(params, trainable)


def unfreeze_epoch(progress, freeze_epochs: int):
    """The epoch of reference_unfreeze_scale at unfreeze progress
    `progress`, a float32 product as in the JAX step."""
    return np.float32(progress) * np.float32(freeze_epochs)


def apply_grad_mask(grads, *masks):
    """grads times every mask, leaf by leaf."""
    for mask in masks:
        grads = tree_map(lambda g, m: g * m, grads, mask)
    return grads


def count_trainable(params, mask):
    """(trainable paths, frozen paths) under `mask`, the reference's
    list_grad / list_no_grad bookkeeping."""
    grad_list, no_grad_list = [], []
    for (path, _), (_, m) in zip(tree_paths(params), tree_paths(mask)):
        (grad_list if m > 0 else no_grad_list).append(path)
    return grad_list, no_grad_list
