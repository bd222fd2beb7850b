"""The port's ring attention (``ops.ring_attention``) against the JAX
package's ``ring_attention`` on the 8 virtual CPU devices, at the meshes
(1, 1, 2), (1, 1, 4) and (1, 2, 2) and, with data ranks, (2, 1, 2): the
output and the gradients of sum(out * w) in q, k and v, with a key mask
(one row whose later blocks hold no valid key), without one, and with a
time length that does not divide by n_seq.  The port runs in 4 gloo
processes on the CPU (one spawn for every case); each rank attends on its
rows, heads and time slice, and the slices are put back together here.

Tolerances: 2e-6 absolute for the output, 1e-5 for the gradients (both
sides sum the same f32 terms in different orders).  Dropout: the
probabilities of a (rank, hop) block keep ~(1 - rate) of their entries, the
kept ones scaled by 1 / (1 - rate), the same on a second run, as
``tests/test_ring_attention.py`` holds the JAX ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speechmix_tpu.ops.ring_attention import ring_attention as j_ring
from speechmix_tpu.parallel import mesh as j_mesh
from speechmix_tpu_torch.ops import ring_attention as t_ring
from speechmix_tpu_torch.parallel import launch
from speechmix_tpu_torch.parallel import mesh as t_mesh
from torch_threads import one_torch_thread  # noqa: F401

import torch_mesh_worker

SCALE = 0.3


def _inputs(seed, b=4, t=24, h=4, d=8, mask=True):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(b, t, h, d).astype(np.float32) * 0.5
                  for _ in range(4))
    case = {"q": q, "k": k, "v": v, "w": w, "scale": SCALE}
    if mask:
        lengths = np.array([t, t - 7, 5, t - 11][:b])
        case["mask"] = np.arange(t)[None, :] < lengths[:, None]
    return case


CASES = [
    ("(1,1,2) masked", (1, 1, 2), dict(seed=0)),
    ("(1,1,4) masked", (1, 1, 4), dict(seed=1)),
    ("(1,2,2) masked", (1, 2, 2), dict(seed=2)),
    ("(2,1,2) masked", (2, 1, 2), dict(seed=3)),
    ("(1,1,4) T=22 uneven", (1, 1, 4), dict(seed=4, t=22)),
    ("(1,1,2) no mask", (1, 1, 2), dict(seed=5, mask=False)),
    ("(1,1,4) no mask, T=21", (1, 1, 4), dict(seed=6, t=21, mask=False)),
]
DROP_RATE = 0.4


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    cases = []
    for _, shape, kw in CASES:
        case = _inputs(**kw)
        case["mesh"] = shape
        cases.append(case)
    # the dropout probe: v = I (D == T) makes the output the dropped
    # probability rows; twice, for determinism
    rng = np.random.RandomState(1)
    t = 16
    probe = {"q": rng.randn(2, t, 2, t).astype(np.float32) * 0.5,
             "k": rng.randn(2, t, 2, t).astype(np.float32) * 0.5,
             "v": np.broadcast_to(np.eye(t, dtype=np.float32)[None, :, None],
                                  (2, t, 2, t)).copy(),
             "w": np.zeros((2, t, 2, t), np.float32), "scale": 0.125,
             "rate": DROP_RATE, "seed": 7, "mesh": (1, 1, 4)}
    cases += [probe, dict(probe)]
    store = launch.file_store(tmp_path_factory.mktemp("ring"))
    per_rank = launch.spawn(torch_mesh_worker.ring_cases, 4, (cases,),
                            init_method=store, timeout_s=240)
    return cases, per_rank


def _assemble(cases, per_rank, i, name):
    """The global (B, T, H, D) array of field `name` of case i."""
    b, t, h, d = cases[i]["q"].shape
    t_pad = max(r[i]["times"].stop for r in per_rank if r[i] is not None)
    out = np.zeros((b, t_pad, h, d), np.float32)
    for r in per_rank:
        part = r[i]
        if part is not None:
            out[part["rows"], part["times"], part["heads"]] = part[name]
    return out[:, :t]


def _jax_ring(case):
    mesh = j_mesh.make_mesh(*case["mesh"])
    mask = case.get("mask")
    mask = None if mask is None else jnp.asarray(mask)
    w = jnp.asarray(case["w"])

    def f(q, k, v):
        return j_ring(q, k, v, mask, scale=case["scale"], mesh=mesh)
    args = [jnp.asarray(case[n]) for n in "qkv"]
    out = f(*args)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[name for name, _, _ in CASES])
def test_ring_matches_jax_ring(port_runs, i):
    cases, per_rank = port_runs
    out, grads = _jax_ring(cases[i])
    np.testing.assert_allclose(_assemble(cases, per_rank, i, "out"), out,
                               rtol=0, atol=2e-6)
    for name, ref in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_assemble(cases, per_rank, i, name), ref,
                                   rtol=0, atol=1e-5, err_msg=name)


def test_ring_dropout_semantics(port_runs):
    cases, per_rank = port_runs
    i = len(CASES)
    got = _assemble(cases, per_rank, i, "out")
    again = _assemble(cases, per_rank, i + 1, "out")
    np.testing.assert_array_equal(got, again)
    q, k = cases[i]["q"], cases[i]["k"]
    s = np.einsum("bqhd,bkhd->bqhk", q, k) * 0.125
    p_ref = np.exp(s - s.max(-1, keepdims=True))
    p_ref /= p_ref.sum(-1, keepdims=True)
    keep = got != 0
    assert abs(keep.mean() - (1 - DROP_RATE)) < 0.03
    np.testing.assert_allclose(got[keep], (p_ref / (1 - DROP_RATE))[keep],
                               rtol=1e-5)


def test_ring_eligibility_gate():
    """The JAX package's predicate on the port's meshes (no process group:
    a Mesh of the shape alone)."""
    mesh = t_mesh.Mesh(2, 1, 4)
    flat = t_mesh.Mesh(8, 1, 1)
    assert t_ring.ring_attention_eligible(mesh, 4, False, False, False)
    assert not t_ring.ring_attention_eligible(None, 4, False, False, False)
    assert not t_ring.ring_attention_eligible(flat, 4, False, False, False)
    assert not t_ring.ring_attention_eligible(mesh, 4, True, False, False)
    assert not t_ring.ring_attention_eligible(mesh, 4, False, True, False)
    assert not t_ring.ring_attention_eligible(mesh, 4, False, False, True)
    mesh_mp = t_mesh.Mesh(1, 2, 4)
    assert not t_ring.ring_attention_eligible(mesh_mp, 3, False, False,
                                              False)
    assert t_ring.ring_attention_eligible(mesh_mp, 4, False, False, False)
