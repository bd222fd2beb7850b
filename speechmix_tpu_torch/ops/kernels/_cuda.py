"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file exports plain C launchers and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``speechmix_tpu_torch/_build/``, then loaded with ``ctypes``.  Every source
is compiled by its own ``nvcc`` process, all started together, at the first
launch of any kernel (or by an explicit ``build_all()``).  A library whose
name carries the hash of its sources is reused if it exists.  Importing
this module needs no ``nvcc`` and no card.

A launcher returns the ``cudaError_t`` of ``cudaGetLastError()`` right
after its launch; ``CudaKernel.launch`` raises if it is not 0 and counts
only launches that were accepted.  Each launch is a ``launch.<symbol>``
span (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ...utils import profiling

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_REGISTRY: list["CudaKernel"] = []
_BUILD_LOCK = threading.Lock()
# ptxas resource lines (registers, shared memory, spills) of the last build
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "speechmix_tpu_torch need the CUDA toolkit")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name == source or name.endswith(".cuh"):
            digest.update(name.encode())
            digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every registered kernel that has no library yet, one nvcc
    process per source, all at once.  Returns the seconds spent.  Raises
    RuntimeError with the compiler's output if any build fails."""
    with _BUILD_LOCK:
        t0 = time.perf_counter()
        # one build per source: a source may export several launchers
        todo = list({k.source: k for k in _REGISTRY
                     if not _lib_path(k.source).exists()}.values())
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for k in todo:
            out = _lib_path(k.source)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-I", str(CSRC), "-o", str(tmp), str(CSRC / k.source)]
            procs.append((k, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for k, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[k.source] = log
            if proc.returncode != 0:
                failed.append(f"--- {k.source} (nvcc exit {proc.returncode})"
                              f"\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" +
                               "\n".join(failed))
        return time.perf_counter() - t0


class CudaKernel:
    """One C launcher in one ``csrc`` source.  ``launches`` counts the
    launches the card accepted since the last reset."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        # the stream is always the last argument
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self.span = "launch." + symbol
        self._fn = None
        _REGISTRY.append(self)

    def _load(self):
        build_all()
        lib = ctypes.CDLL(str(_lib_path(self.source)))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args):
        import torch
        fn = self._fn or self._load()
        with profiling.annotate(self.span):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1


def kernels() -> list["CudaKernel"]:
    return list(_REGISTRY)


def reset_launch_counts():
    for k in _REGISTRY:
        k.launches = 0


def resolve_device(device=None):
    """`device` as a torch.device; None means the card.  Raises if the card
    is asked for and CUDA is not available: the port never moves to the CPU
    on its own."""
    import torch
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def check_cuda_tensor(name: str, t, dtype=None, shape=None, device=None):
    """Raise ValueError unless `t` is a contiguous CUDA tensor of the given
    dtype/shape on `device`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name: str, t, nbytes: int):
    """Raise ValueError unless `t`'s data starts on an `nbytes` boundary (the
    kernels load their operands in words of that size)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")


def dtype_code(dtype) -> int:
    """0 = float32, 1 = bfloat16 (the `dtype` argument of every launcher)."""
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(f"unsupported dtype {dtype}: the kernels take float32 "
                     "or bfloat16")
