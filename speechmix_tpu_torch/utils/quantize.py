"""Weight-only int8 quantization for serving (port of
``speechmix_tpu.utils.quantize``).

Dense kernels are stored as int8 codes with per-output-channel float32
scales and dequantized where ``ops.layers.dense`` reads them; the tied LM
head's table as int8 with per-row scales (``ops.layers.embed`` and the
seq2seq head read it).  The same entry points take the quantized tree:

    q_params = quantize_weights(params)
    tokens, _ = generate(q_params, cfg, ...)

The rules are the JAX package's, on the port's tree, whose layer stacks are
lists (``convert.params_from_jax``):
  * a 2-D kernel outside a layer list quantizes when it has at least
    min_size elements;
  * a kernel inside a list the JAX package stacks (the three transformer
    stacks and the adapters) quantizes per (layer, output channel) when its
    parameter NAME is a known stacked dense (``_STACKED_DENSE_NAMES``, so
    T5's bias-free stacks quantize too) and the stacked size, layers times
    elements, is at least min_size;
  * ``shared.embedding`` becomes ``embedding_q`` + ``embedding_scale``.
Norms, biases, convs, position tables and small kernels stay as they are.
The codes are ``round(w / s)`` clipped to [-127, 127] with
``s = max(max|w| / 127, 1e-12)`` in float32, the JAX package's bits, so
``quantize_weights(params_from_jax(tree))`` equals
``params_from_jax(jax_quantize_weights(tree))``.
"""

from __future__ import annotations

import torch

from ..convert import _stacked_in_jax

# parameter names whose 3-D kernels the JAX package stacks per layer
_STACKED_DENSE_NAMES = frozenset({
    "q_proj", "k_proj", "v_proj", "out_proj",
    "fc1", "fc2", "fc_gate", "ffn_in", "ffn_out",
    "down", "up",
})


def _quantize_kernel(w):
    """(in, out) kernel -> int8 codes + (out,) float32 scales."""
    wf = w.float()
    scale = (wf.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _quantize_rows(w):
    """(V, H) embedding / LM-head table -> int8 codes + (V,) per-row float32
    scales (the rows are the head's output channels)."""
    wf = w.float()
    scale = (wf.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weights(params, min_size: int = 4096,
                     quantize_tied_head: bool = True):
    """The port's parameter tree with its dense kernels replaced by
    ``kernel_q`` (int8) + ``kernel_scale`` (float32, per output channel)
    and, with quantize_tied_head, ``shared.embedding`` by ``embedding_q`` +
    ``embedding_scale`` (per row); see the module docstring for which.
    Other leaves are shared with `params`, not copied."""

    def walk(node, name=None, path=(), n_stacked=0):
        if isinstance(node, dict):
            if quantize_tied_head and name == "shared" and \
                    "embedding" in node and node["embedding"].ndim == 2 and \
                    node["embedding"].numel() >= min_size:
                q, s = _quantize_rows(node["embedding"])
                out = {k: walk(v, k, path + (k,), n_stacked)
                       for k, v in node.items() if k != "embedding"}
                out["embedding_q"], out["embedding_scale"] = q, s
                return out
            w = node.get("kernel")
            if isinstance(w, torch.Tensor) and w.ndim == 2:
                if n_stacked:
                    quantizable = (name in _STACKED_DENSE_NAMES and
                                   n_stacked * w.numel() >= min_size)
                else:
                    quantizable = w.numel() >= min_size
                if quantizable:
                    q, s = _quantize_kernel(w)
                    out = {k: walk(v, k, path + (k,), n_stacked)
                           for k, v in node.items() if k != "kernel"}
                    out["kernel_q"], out["kernel_scale"] = q, s
                    return out
            return {k: (walk(v, k, path + (k,), len(v))
                        if isinstance(v, list) and _stacked_in_jax(path, k)
                        else walk(v, k, path + (k,), n_stacked))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name, path, n_stacked) for v in node]
        return node

    return walk(params)


def quantization_report(params):
    """(n_quantized_elements, n_total_elements) over the tree."""
    n_q = n_t = 0

    def walk(node):
        nonlocal n_q, n_t
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            n_t += node.numel()
            if node.dtype == torch.int8:
                n_q += node.numel()
    walk(params)
    return n_q, n_t


def fuse_qkv_params(params):
    """Serving-time transform: every self-attention subtree ("attention" in
    the speech encoder, "self_attn" in the BART / T5 stacks) gets its q/k/v
    projections as one pre-concatenated (Din, 3*H*D) ``qkv_proj`` entry
    (read by ``ops.attention.attention``): one product and one read of the
    activations instead of three.  Cross-attention ("encoder_attn") keeps
    separate projections (its K/V are precomputed over the encoder output).
    Quantized subtrees fuse too (codes and scales concatenated).  For
    inference trees only: export and training take the unfused tree."""

    def fuse(attn):
        names = ("q_proj", "k_proj", "v_proj")
        if not all(n in attn for n in names):
            return attn
        ps = [attn[n] for n in names]
        fused = {}
        if all("kernel" in p for p in ps):
            fused["kernel"] = torch.cat([p["kernel"] for p in ps], dim=-1)
        elif all("kernel_q" in p for p in ps):
            fused["kernel_q"] = torch.cat([p["kernel_q"] for p in ps],
                                          dim=-1)
            fused["kernel_scale"] = torch.cat(
                [p["kernel_scale"] for p in ps], dim=-1)
        else:
            return attn
        if all("bias" in p for p in ps):
            fused["bias"] = torch.cat([p["bias"] for p in ps], dim=-1)
        out = {k: v for k, v in attn.items() if k not in names}
        out["qkv_proj"] = fused
        return out

    def walk(node, name=None):
        if isinstance(node, dict):
            if name in ("attention", "self_attn"):
                node = fuse(node)
            return {k: (walk(v, k) if k != "qkv_proj" else v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return node

    return walk(params)
