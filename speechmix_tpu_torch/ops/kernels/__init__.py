"""The port's hand-written CUDA kernels, their wrappers and plain versions.

K1 ``attention.attention_fwd``, K2 ``ffn.dense_res_ln``, K3
``ffn.ffn_res_ln``, K4 ``decode_attention.decode_attention`` (float and int8
K/V entries), K5 ``beam_gather.beam_gather``, K6
``conv_extractor.fused_conv_layer`` (its backward in the stack:
``conv_extractor.conv_layer_backward``, three passes of ``conv_bwd.cu``),
K7 ``attention.attention_bwd``, K8
``ffn.ffn_bwd`` (bfloat16: ``ffn.ffn_bwd_recompute`` then
``ffn.ffn_bwd_products``; float32: the same two passes in their f32
entries, with f32-accurate products on the tensor cores),
K9 ``ffn.ffn_fused``; the dropout kernels K10 ``dropout.dropout_mask``, K11
``ffn.dense_dropout_res_ln``, K12 ``ffn.ffn_dropout_res_ln``, K13
``ffn.ffn_dropout``, K14 ``attention.attention_dropout_fwd``, K15
``attention.attention_dropout_bwd`` and K8 with the activation mask
``ffn.ffn_dropout_bwd`` (its own recompute entry, the same products).
A wrapper runs its plain PyTorch version for a CPU tensor, and launches its
kernel or raises for a CUDA tensor.  Importing the package registers every
kernel, so ``build_all()`` builds all of them.
"""

from . import (attention, beam_gather, conv_extractor,  # noqa: F401
               decode_attention, dropout, ffn)  # (registers the kernels)
from ._cuda import build_all, kernels, reset_launch_counts  # noqa: F401
