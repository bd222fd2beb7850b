"""The reference's optimizer and the leaves it works on.

The recipe (SpeechMix's HF Trainer setting as the JAX package fixed it,
optax's ``chain(clip_by_global_norm(max_norm), adafactor(schedule,
multiply_by_parameter_scale=False, min_dim_size_to_factor=0))``): clip the
whole gradient to global norm ``max_norm``; then per leaf the factored
second moment (decay 1 - (count + 1)^-0.8, 1e-30 added to g^2; a leaf of
two or more dimensions keeps row and column means over its two largest
axes, np.argsort's last two, a vector the full moment), the gradient scaled
by its inverse square root, clipped to RMS 1, times -lr; lr is a linear
warmup from 0 over ``warmup`` updates, counted from 0.

Leaves are those of the JAX layout: each transformer layer list is one
leaf per parameter stacked on a leading layer axis, a conv kernel is
(k, C_in, C_out).  ``groups`` names them by their "/"-joined path.
"""

from __future__ import annotations

import numpy as np
import torch

DECAY, EPS, CLIP = 0.8, 1e-30, 1.0


def _stacked(path, key):
    return key == "layers" and path[-1:] != ("feature_extractor",)


def groups(tree, path=()):
    """[(name, [tensors], conv, stacked)] in tree order."""
    out = []
    if isinstance(tree, dict):
        if "kernel" in tree and tree["kernel"].ndim == 3:
            return [("/".join(path + (k,)), [v], k == "kernel", False)
                    for k, v in tree.items()]
        for k, v in tree.items():
            if _stacked(path, k):
                for name, _, conv, _ in groups(v[0], path + (k,)):
                    sub = name[len("/".join(path + (k,))) + 1:].split("/")
                    tensors = [_at(layer, sub) for layer in v]
                    out.append((name, tensors, conv, True))
            else:
                out += groups(v, path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += groups(v, path + (str(i),))
        return out
    return [("/".join(path), [tree], False, False)]


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def jax_view(tensors, conv, stacked):
    """The leaf in the JAX layout (float32)."""
    t = [x.float() for x in tensors]
    if conv:
        t = [x.permute(2, 1, 0) for x in t]
    return torch.stack(t) if stacked else t[0]


def jax_shape(tensors, conv, stacked):
    shape = tuple(tensors[0].shape)
    if conv:
        shape = shape[::-1]
    return (len(tensors),) + shape if stacked else shape


def factored_dims(shape):
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    return int(order[-2]), int(order[-1])


def lr_at(count, lr, warmup):
    return lr * count / warmup if count < warmup else lr


class Adafactor:
    def __init__(self, lr, warmup, max_norm):
        self.lr, self.warmup, self.max_norm = lr, warmup, max_norm
        self.state = {}
        self.count = 0

    @torch.no_grad()
    def step(self, leaves, grads):
        """leaves, grads: {name: (tensors, conv, stacked)} and {name: the
        gradient in the JAX layout}.  Updates the tensors in place; returns
        the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = self.max_norm / norm if norm >= self.max_norm else 1.0
        decay = float(np.float32(1.0) - np.float32(self.count + 1)
                      ** np.float32(-DECAY))
        lr = lr_at(self.count, self.lr, self.warmup)
        clipped = {}
        for name, (tensors, conv, stacked) in leaves.items():
            g = grads[name] * scale
            clipped[name] = g
            g2 = g * g + EPS
            dims = factored_dims(tuple(g.shape))
            st = self.state.setdefault(name, {})
            if dims is None:
                v = st.get("v", torch.zeros_like(g))
                st["v"] = v = decay * v + (1 - decay) * g2
                u = g / v.sqrt()
            else:
                d1, d0 = dims
                r = g2.mean(d0)
                c = g2.mean(d1)
                st["row"] = vr = decay * st.get("row", torch.zeros_like(r)) \
                    + (1 - decay) * r
                st["col"] = vc = decay * st.get("col", torch.zeros_like(c)) \
                    + (1 - decay) * c
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(rd1, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            rms = torch.sqrt(torch.mean(u * u)) / CLIP
            u = u / torch.clamp_min(rms, 1.0) * -lr
            parts = u.unbind(0) if stacked else [u]
            for t, part in zip(tensors, parts):
                t.add_(part.permute(2, 1, 0) if conv else part)
        self.count += 1
        return clipped
