"""The configuration's dtype string as a torch dtype (the counterpart of
``speechmix_tpu.utils.platform.jnp_dtype``)."""

import torch


def torch_dtype(name: str):
    """"bfloat16" -> torch.bfloat16; anything else -> torch.float32."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32
