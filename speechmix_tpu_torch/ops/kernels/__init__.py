"""The port's hand-written CUDA kernels, their wrappers and plain versions.

K1 ``attention.attention_fwd``, K2 ``ffn.dense_res_ln``, K3
``ffn.ffn_res_ln``, K4 ``decode_attention.decode_attention`` (float and int8
K/V entries), K5 ``beam_gather.beam_gather``, K6
``conv_extractor.fused_conv_layer``.  A wrapper runs its plain PyTorch version for a CPU
tensor, and launches its kernel or raises for a CUDA tensor.  Importing
the package registers every kernel, so ``build_all()`` builds all of them.
"""

from . import (attention, beam_gather, conv_extractor,  # noqa: F401
               decode_attention, ffn)  # (registers the kernels)
from ._cuda import build_all, kernels, reset_launch_counts  # noqa: F401
