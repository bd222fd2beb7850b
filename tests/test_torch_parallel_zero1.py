"""The port's train step at the (2, 2, 1) mesh (two data ranks, two model
ranks) against the JAX package's ``make_train_step(..., mesh=)`` at that
mesh: ZeRO-1 under AdamW and under Adafactor, the gan variant (its BCE
over the global batch, its alternating masks), and a T5 pair
(tiny-t5-bytes: gated-free relu FFN, per-head position bias sliced to the
model rank's heads) under Adafactor with ZeRO-1.  Configuration, inputs,
steps and limits are ``test_torch_parallel_train.py``'s.

ZeRO-1 holds each data rank to its share: at most half of the optimizer
state it would hold without ZeRO-1 plus the largest leaf's (AdamW: both
moments of the leaf; Adafactor: its statistics), and the two data ranks'
shares add up to that state."""

import pytest

from test_torch_parallel_train import (check_against_jax,
                                       check_replicas_equal, _jax_steps,
                                       run_port)
from torch_threads import one_torch_thread  # noqa: F401

EED = ("tiny-speech", "tiny-bart-bytes", 2, 2, "eed")
# name: (config spec, mesh, optimizer, zero1)
CASES = {
    "dp x tp zero1 adamw (2,2,1)": (EED, (2, 2, 1), "adamw", True),
    "dp x tp zero1 adafactor (2,2,1)": (EED, (2, 2, 1), "adafactor", True),
    "gan (2,2,1)": (("tiny-speech", "tiny-bart-bytes", 2, 2, "gan"),
                    (2, 2, 1), "adamw", False),
    "t5 zero1 adafactor (2,2,1)": (
        ("tiny-speech", "tiny-t5-bytes", 2, 2, "eed"), (2, 2, 1),
        "adafactor", True),
}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return run_port(CASES, tmp_path_factory.mktemp("zero1"))


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_jax_mesh_step(port_runs, name):
    """ZeRO-1 changes no number of the step (the JAX package's own claim).
    Its ZeRO-1 AdamW step at (2, 2, 1) does not hold it: its parameters
    move at the warmup step's rate 0 (loss 6.31987 at step 2 against
    6.32102 of its one-card, its (2, 1, 1) ZeRO-1 and its (2, 2, 1)
    replicated steps), so that case is held to the JAX (2, 2, 1) step
    without ZeRO-1."""
    spec, shape, opt, zero1 = CASES[name]
    ref = _jax_steps(name, CASES,
                     zero1=False if (opt == "adamw" and zero1) else None)
    check_against_jax(port_runs[name], ref)


@pytest.mark.parametrize("name", list(CASES))
def test_model_group_replicas_stay_equal(port_runs, name):
    check_replicas_equal(port_runs[name])


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][3]])
def test_zero1_keeps_a_share_of_the_state(port_runs, name):
    ranks = port_runs[name]
    for r in ranks:
        bound = r["unsharded_opt_bytes"] / 2 + r["max_leaf_bytes"]
        print(f"{name} rank {r['coords']}: optimizer state "
              f"{r['opt_bytes']} bytes, {r['unsharded_opt_bytes']} without "
              f"ZeRO-1 (bound {bound:.0f})")
        assert r["opt_bytes"] <= bound, (r["coords"], r["opt_bytes"], bound)
    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coords"][1], []).append(r)
    for shares in by_model.values():
        assert sum(r["opt_bytes"] for r in shares) == \
            shares[0]["unsharded_opt_bytes"]
