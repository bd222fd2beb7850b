"""ctypes bindings for the port's native host runtime (runtime/native.cpp):
resample, normalize and edit distance (port of
``speechmix_tpu.runtime.native``).

The library is built with g++ at its first use into
``speechmix_tpu_torch/_build/``, under a name that carries the hash of its
source and flags, so a changed source is rebuilt and a built one reused.
A build writes a temporary file and renames it, so processes that build at
the same moment each find a whole library.  A failed build raises with the
compiler's output: ``data/audio.py`` and ``metrics.py`` call the library
and have no silent fallback.  Their numpy versions (``resample_plain``,
``normalize_plain``, ``_edit_distance_plain``) are the plain versions the
tests hold it against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there.  Raises
    RuntimeError if there is no compiler or the build fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: speechmix_tpu_torch's native "
                           "runtime needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({CXX} exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.smx_resample.restype = i64
        lib.smx_resample.argtypes = [f32p, i64, i64, i64, f32p, i64]
        lib.smx_resample_out_len.restype = i64
        lib.smx_resample_out_len.argtypes = [i64, i64, i64]
        lib.smx_normalize.restype = None
        lib.smx_normalize.argtypes = [f32p, i64, ctypes.c_float]
        lib.smx_edit_distance.restype = i64
        lib.smx_edit_distance.argtypes = [i32p, i64, i32p, i64]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library is built or a compiler is there to build it."""
    return lib_path().exists() or shutil.which(CXX) is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resample(waveform: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample of a mono float32 waveform (up / down by the
    rates' gcd)."""
    lib = _load()
    wav = np.ascontiguousarray(waveform, np.float32)
    max_out = int(lib.smx_resample_out_len(len(wav), sr_in, sr_out)) + 8
    out = np.empty(max_out, np.float32)
    n = lib.smx_resample(_ptr(wav, ctypes.c_float), len(wav), sr_in, sr_out,
                         _ptr(out, ctypes.c_float), max_out)
    return out[:n]


def normalize(waveform: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Zero-mean unit-variance copy of a float32 waveform."""
    lib = _load()
    wav = np.array(waveform, np.float32)  # a contiguous copy
    lib.smx_normalize(_ptr(wav, ctypes.c_float), len(wav), eps)
    return wav


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two int32 id sequences."""
    lib = _load()
    r = np.ascontiguousarray(ref, np.int32)
    h = np.ascontiguousarray(hyp, np.int32)
    return int(lib.smx_edit_distance(_ptr(r, ctypes.c_int32), len(r),
                                     _ptr(h, ctypes.c_int32), len(h)))
