"""Packaging for speechmix_tpu (reference: /root/reference/setup.py).

The native runtime (speechmix_tpu/runtime/native.cpp) is built on demand at
first use via g++ (see runtime/native.py); no build step is required at
install time, and every native entry point has a pure-numpy fallback.
"""

from setuptools import find_packages, setup

setup(
    name="speechmix_tpu",
    version="0.1.0",
    description=("TPU-native speech-to-text fusion framework "
                 "(JAX/XLA/Pallas): wav2vec2/HuBERT-family encoders fused "
                 "into BART/T5-family seq2seq LMs with SpeechMix-compatible "
                 "training regimes"),
    packages=find_packages(exclude=("tests",)),
    package_data={"speechmix_tpu.runtime": ["native.cpp"],
                  "speechmix_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
    ],
    extras_require={
        "hf": ["transformers>=4.30", "datasets", "torch"],
        "test": ["pytest"],
    },
)
