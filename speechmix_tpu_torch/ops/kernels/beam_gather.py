"""K5: the beam-search reorder of the decoder's self-attention cache.

``beam_gather`` launches ``csrc/beam_gather.cu`` for CUDA tensors and runs
``beam_gather_plain`` for CPU tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/beam_gather.py: beam_gather``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor

KERNEL = CudaKernel(
    "beam_gather.cu", "smx_beam_gather",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong] +
    [ctypes.c_int])


def beam_gather_plain(key, value, src_rows, out=None):
    """out[:, n] = in[:, src_rows[n]] for key and value (L, N, *rest);
    src_rows: (N,) integer source rows.  `out`, when given, is a
    (key, value) pair of buffers to write into.  Returns (key', value')."""
    idx = src_rows.long()
    if out is None:
        return key.index_select(1, idx), value.index_select(1, idx)
    torch.index_select(key, 1, idx, out=out[0])
    torch.index_select(value, 1, idx, out=out[1])
    return out


def beam_gather(key, value, src_rows, out=None):
    """K5; see beam_gather_plain.  A pure copy, exact for every dtype.  CUDA
    tensors need contiguous 16-byte aligned key and value of one shape and
    dtype, an int32 src_rows with every entry in [0, N), (L, n) slabs of a
    multiple of 16 bytes, and `out` buffers (allocated when None) that are
    not the inputs: the permutation is not done in place."""
    if key.device.type == "cpu":
        return beam_gather_plain(key, value, src_rows, out)
    check_cuda_tensor("key", key)
    if key.ndim < 3:
        raise ValueError(f"beam_gather needs (L, N, *rest) buffers, got "
                         f"{tuple(key.shape)}")
    check_cuda_tensor("value", value, key.dtype, key.shape, key.device)
    layers, rows = key.shape[:2]
    check_cuda_tensor("src_rows", src_rows, torch.int32, (rows,), key.device)
    slab_bytes = math.prod(key.shape[2:]) * key.element_size()
    if slab_bytes % 16:
        raise ValueError(f"beam_gather moves 16-byte words: a (layer, row) "
                         f"slab of {slab_bytes} bytes is not a multiple")
    if out is None:
        out = (torch.empty_like(key), torch.empty_like(value))
    for name, o in (("out key", out[0]), ("out value", out[1])):
        check_cuda_tensor(name, o, key.dtype, key.shape, key.device)
        if o.data_ptr() in (key.data_ptr(), value.data_ptr()):
            raise ValueError(f"{name} is an input buffer: beam_gather cannot "
                             "permute in place")
    for name, x in (("key", key), ("value", value), ("out key", out[0]),
                    ("out value", out[1])):
        check_aligned(name, x, 16)
    KERNEL.launch(key.data_ptr(), value.data_ptr(), src_rows.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), layers, rows,
                  slab_bytes, key.device.index)
    return out
