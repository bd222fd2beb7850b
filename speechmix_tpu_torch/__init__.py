"""PyTorch + CUDA port of speechmix_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and numpy,
never jax or speechmix_tpu.  Entry points run on the card unless the caller
passes ``device="cpu"``.  The hand-written CUDA kernels (``csrc/``) are
built with nvcc at their first CUDA launch; see ``ops.kernels``.

The twelve model classes of the reference's API (``SpeechMixEED`` and the
rest, ``speechmix_tpu_torch.api``) are imported on first use.
"""

_API_NAMES = frozenset({
    "SpeechMixED", "SpeechMixEED", "SpeechMixFixed", "SpeechMixAdapter",
    "SpeechMixSelf", "SpeechMixGAN", "HFSpeechMixED", "HFSpeechMixEED",
    "HFSpeechMixFixed", "HFSpeechMixAdapter", "HFSpeechMixSelf",
    "HFSpeechMixGAN",
})


def __getattr__(name):
    if name in _API_NAMES:
        from . import api
        return getattr(api, name)
    raise AttributeError(
        f"module 'speechmix_tpu_torch' has no attribute {name!r}")
