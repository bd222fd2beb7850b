"""The port's TranscriptionPipeline over a mesh against the JAX package's
pipeline, float32 on the CPU, on the same weights: data parallel (2, 1),
tensor parallel (1, 2) and both (2, 2) (meshes (data, model)), greedy and
beam-4, give the JAX pipeline's transcripts on every rank.  The port runs
in 4 gloo processes (one spawn for every case).  The inputs cover two
buckets, a partial batch, a chunked long input and inputs too short for a
frame.  Under tensor parallelism the decode keeps the local heads' K / V
(K4 and K5's plain versions on them; int8 cross K/V too) and fuse_qkv is
off; int8 weights split as their float kernels; the batch must divide
over the data ranks."""

import jax
import numpy as np
import pytest

import speechmix_tpu
import speechmix_tpu_torch
from speechmix_tpu import pipeline as j_pipe
from speechmix_tpu_torch import pipeline as t_pipe
from speechmix_tpu_torch.parallel import launch
from speechmix_tpu_torch.parallel import mesh as t_mesh
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_worker

KW = dict(batch_size=4, max_length=6, buckets_sec=(0.5, 1.0))
MODES = {"greedy": dict(num_beams=1), "beam-4": dict(num_beams=4)}
MESHES = {"(2,1)": (2, 1, 1), "(1,2)": (1, 2, 1), "(2,2)": (2, 2, 1)}


def _waveforms():
    rng = np.random.RandomState(0)
    lens = [12000, 5000, 16000, 36800, 30, 7000, 9000, 15000, 4000]
    return [rng.randn(n).astype(np.float32) * 0.1 for n in lens]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    j = speechmix_tpu.HFSpeechMixEED("tiny-speech", "tiny-bart-bytes",
                                     down_scale=2)
    tree = setup_tree()
    j.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    wavs = _waveforms()
    cases = [{"mesh": shape, "kw": dict(KW, **mode)}
             for mode in MODES.values() for shape in MESHES.values()]
    cases += [{"mesh": (1, 2, 1), "kw": dict(KW, kv_int8=True)},
              {"mesh": (1, 2, 1), "kw": KW, "int8_weights": True}]
    per_rank = launch.spawn(
        torch_mesh_worker.serving_cases, 4, (tree, wavs, cases),
        init_method=launch.file_store(tmp_path_factory.mktemp("serve")),
        timeout_s=240)
    return j, wavs, per_rank


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_pipeline_matches_jax(setup, mode):
    j, wavs, per_rank = setup
    want = j_pipe.TranscriptionPipeline(j, **KW, **MODES[mode])(wavs)
    i0 = list(MODES).index(mode) * len(MESHES)
    for k, name in enumerate(MESHES):
        ranks = [r[i0 + k] for r in per_rank if r[i0 + k] is not None]
        assert len(ranks) == int(np.prod(MESHES[name]))
        for r in ranks:
            assert r["texts"] == want, (mode, name, r["coords"])


@pytest.mark.parametrize("case", ["int8 cross K/V", "int8 weights"])
def test_int8_over_tensor_parallelism(setup, case):
    """Over (1, 2): int8 cross K/V of the local heads, and int8 weights
    (kernel_q shares with their scales sliced at use), give the one-card
    port's transcripts (the port's one-card int8 paths are held to the
    JAX package's in test_torch_quantize.py / test_torch_decode.py)."""
    from speechmix_tpu_torch.utils.quantize import quantize_weights
    _, wavs, per_rank = setup
    i = 2 * len(MESHES) + ["int8 cross K/V", "int8 weights"].index(case)
    model = torch_mesh_worker._tiny_model(setup_tree())
    kw = dict(KW)
    if case == "int8 weights":
        model.params = quantize_weights(model.params, min_size=1)
    else:
        kw["kv_int8"] = True
    want = t_pipe.TranscriptionPipeline(model, **kw)(wavs)
    ranks = [r[i] for r in per_rank if r[i] is not None]
    assert len(ranks) == 2
    for r in ranks:
        assert r["texts"] == want, (case, r["coords"])


def setup_tree():
    j = speechmix_tpu.HFSpeechMixEED("tiny-speech", "tiny-bart-bytes",
                                     down_scale=2)
    return _tree(j.config, 0.3, seed=2)


def test_batch_must_divide_over_data_ranks():
    """The JAX package's check, and fuse_qkv turned off under tensor
    parallelism (a mesh of the shape alone: no process group)."""
    t = speechmix_tpu_torch.HFSpeechMixEED("tiny-speech", "tiny-bart-bytes",
                                           down_scale=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh data-axis"):
        t_pipe.TranscriptionPipeline(t, batch_size=3,
                                     mesh=t_mesh.Mesh(2, 1, 1, device="cpu"))
    pipe = t_pipe.TranscriptionPipeline(
        t, batch_size=2, fuse_qkv=True,
        mesh=t_mesh.Mesh(1, 2, 1, device="cpu"))
    assert pipe.fuse_qkv is False
    assert t_pipe.TranscriptionPipeline(
        t, batch_size=2, fuse_qkv=True,
        mesh=t_mesh.Mesh(2, 1, 1, device="cpu")).fuse_qkv is True
