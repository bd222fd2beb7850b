"""The port's native host runtime (``speechmix_tpu_torch/runtime``: its
copy of native.cpp, built by g++ into ``_build/``) against the port's numpy
plain versions and the JAX package's native runtime and numpy paths.

Edit distances are integers and must be equal.  resample and normalize are
float32 outputs of float64 (C++) and float32 / float64 (numpy) arithmetic:
resample within 1e-6 absolute (inputs of scale 0.1, as the JAX package's
own test holds its library against its numpy path), normalize within
1e-6 + 1e-6 |x| (outputs of order 1, about ten float32 ulps).  Cases:
lengths 0, 1 and odd, the rates 8, 22.05, 44.1 and 48 kHz, empty
sequences.  A build without a compiler, or a failed one, raises; nothing
falls back to numpy.
"""

import ctypes
import threading

import numpy as np
import pytest

from speechmix_tpu import metrics as j_metrics
from speechmix_tpu.data import audio as j_audio
from speechmix_tpu.runtime import native as j_native
from speechmix_tpu_torch import metrics as t_metrics
from speechmix_tpu_torch.data import audio as t_audio
from speechmix_tpu_torch.runtime import native
from torch_threads import one_torch_thread  # noqa: F401

RATES = (8000, 22050, 44100, 48000)


def _wave(n, seed=0):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("n", [0, 1, 7, 4001, None],
                         ids=["0", "1", "7", "4001", "quarter-second"])
def test_resample_matches_plain_and_jax(sr, n, monkeypatch):
    x = _wave(sr // 4 if n is None else n, seed=sr)
    got = native.resample(x, sr, 16000)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(t_audio.resample(x, sr), got)
    want = t_audio.resample_plain(x, sr, 16000)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if j_native.available():
        np.testing.assert_allclose(got, j_native.resample(x, sr, 16000),
                                   rtol=0, atol=1e-6)
    monkeypatch.setattr(j_native, "available", lambda: False)
    np.testing.assert_allclose(got, j_audio.resample(x, sr, 16000), rtol=0,
                               atol=1e-6)


def test_resample_same_rate_is_a_copy():
    x = _wave(101)
    np.testing.assert_array_equal(t_audio.resample(x, 16000), x)


@pytest.mark.parametrize("n", [0, 1, 7, 4001, 64000])
def test_normalize_matches_plain_and_jax(n, monkeypatch):
    x = _wave(n, seed=n) * 3.0 + 0.25
    got = t_audio.normalize(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert got is not x
    if n == 0:
        return
    for want in (t_audio.normalize_plain(x),
                 j_native.normalize(x) if j_native.available() else None):
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(j_native, "available", lambda: False)
    np.testing.assert_allclose(got, j_audio.normalize(x), rtol=1e-6,
                               atol=1e-6)


def _sequences(seed):
    rng = np.random.RandomState(seed)
    pairs = [([], []), ([], [1, 2]), ([3], []), ([5], [5]), ([1, 2, 3],
                                                             [3, 2, 1])]
    for _ in range(40):
        n, m = rng.randint(0, 30, size=2)
        pairs.append((rng.randint(0, 6, n).tolist(),
                      rng.randint(0, 6, m).tolist()))
    return pairs


def test_edit_distance_matches_plain_and_jax(monkeypatch):
    for ref, hyp in _sequences(0):
        got = native.edit_distance(ref, hyp)
        assert got == t_metrics._edit_distance(ref, hyp)
        assert got == t_metrics._edit_distance_plain(ref, hyp)
        assert got == j_metrics._edit_distance(ref, hyp)
        words = (["w%d" % t for t in ref], ["w%d" % t for t in hyp])
        assert t_metrics._edit_distance(*words) == got
    monkeypatch.setattr(j_native, "available", lambda: False)
    for ref, hyp in _sequences(1):
        assert t_metrics._edit_distance(ref, hyp) == \
            j_metrics._edit_distance(ref, hyp)


def test_wer_cer_match_jax():
    refs = ["the cat sat", "", "a b c d", "hello world"]
    hyps = ["the bat sat down", "x", "", "hello world"]
    assert t_metrics.wer(refs, hyps) == j_metrics.wer(refs, hyps)
    assert t_metrics.cer(refs, hyps) == j_metrics.cer(refs, hyps)


def _fresh(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No g++: the first call raises, through audio and metrics too."""
    _fresh(monkeypatch, tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    assert not native.available()
    x = _wave(100)
    for call in (lambda: native.resample(x, 22050, 16000),
                 lambda: t_audio.resample(x, 22050),
                 lambda: t_audio.normalize(x),
                 lambda: t_metrics.wer(["a b"], ["a c"])):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
    assert not (tmp_path / "build").exists() or \
        not list((tmp_path / "build").iterdir())


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    _fresh(monkeypatch, tmp_path)
    bad = tmp_path / "native.cpp"
    bad.write_text("int smx_resample( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        t_metrics.cer(["ab"], ["ac"])
    assert list((tmp_path / "build").iterdir()) == []


def test_concurrent_builds_each_find_a_whole_library(monkeypatch, tmp_path):
    """Builds that start at once (the tests' worker processes) write
    temporary files and rename them: every caller gets a library that
    loads, under the one hashed name."""
    _fresh(monkeypatch, tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0] == native.lib_path()
    assert paths[0].parent == tmp_path / "build"
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        [paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    assert lib.smx_resample_out_len(16000, 48000, 16000) == 5334
    assert native.available()
