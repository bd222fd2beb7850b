"""The port's hand-written CUDA kernels, their wrappers and plain versions.

K1 ``attention.attention_fwd``, K2 ``ffn.dense_res_ln``, K3
``ffn.ffn_res_ln``.  A wrapper runs its plain PyTorch version for a CPU
tensor, and launches its kernel or raises for a CUDA tensor.  Importing
the package registers every kernel, so ``build_all()`` builds all of them.
"""

from . import attention, ffn  # noqa: F401  (registers the kernels)
from ._cuda import build_all, kernels, reset_launch_counts  # noqa: F401
