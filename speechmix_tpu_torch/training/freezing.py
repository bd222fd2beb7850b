"""Parameter freezing as masks over the parameter tree (port of
``speechmix_tpu.training.freezing``).

A mask is a tree shaped like the parameters whose leaves are the Python
floats 0.0 (frozen) or 1.0 (trainable); ``apply_grad_mask`` multiplies
gradients by it inside the train step.  Paths are the '/'-joined keys and
list indices from the root ("nlp/decoder/layers/3/fc1/kernel"; the JAX
package stacks the layers and has no index there, which no predicate reads).
Trees are walked in insertion order, which the model initialisers and
``convert.params_from_jax`` keep to HF's registration order: the speech
encoder's ``masked_spec_embed`` first, then the extractor, as the JAX
package's tensor ranking orders them (its freezing.py, ``_PRE_GROUPS``).
Gradual unfreezing and the GAN's alternating masks are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

from ..config import SpeechMixConfig
from ..models.speechmix import PORTED_VARIANTS

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
    """Static trainable mask of each ported variant:

    eed:   everything trainable;
    ed:    everything except the conv feature extractor;
    fixed: the speech encoder and / or the NLP model frozen per flag.

    With cfg.fixed_parameters the fixed_parameters_mask multiplies in."""
    v = cfg.variant
    if v not in PORTED_VARIANTS:
        raise NotImplementedError(f"the {v!r} variant is not ported yet")

    def pred(path):
        if v == "ed":
            return not path.startswith(
                f"speech_encoder{SEP}feature_extractor")
        if v == "fixed":
            if path.startswith("speech_encoder") and fixed_speech:
                return False
            if path.startswith("nlp") and fixed_nlp:
                return False
        return True

    mask = mask_from_predicate(params, pred)
    if cfg.fixed_parameters:
        fixed = fixed_parameters_mask(params, cfg.fixed_except)
        mask = tree_map(lambda a, b: a * b, mask, fixed)
    return mask


def apply_grad_mask(grads, *masks):
    """grads times every mask, leaf by leaf."""
    for mask in masks:
        grads = tree_map(lambda g, m: g * m, grads, mask)
    return grads
