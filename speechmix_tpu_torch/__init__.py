"""PyTorch + CUDA port of speechmix_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax or speechmix_tpu.  Entry points run on the card unless the caller
passes ``device="cpu"``.  The hand-written CUDA kernels (``csrc/``) are
built with nvcc at their first CUDA launch; see ``ops.kernels``.
"""
