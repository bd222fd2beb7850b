"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, all seeds in one process:

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... \
        --controls 3 [--fault <name>]

For each seed: the program's numbers as a run reads them (training: the
three set-up steps through the window's step; transcription: one call of
each pool batch, the same sample of rows as a run), against the float32
reference; training also names the leaf of ``delta_gap_worst`` and its
reference gradient's norm over the median leaf's.  For the first ``--controls`` seeds also the control's: the
reference computed one precision below the cell's (tf32 below float32,
fp8 below bfloat16) in the program's place.  With ``--fault`` the
program runs with a fault of ``faults.py`` planted.  Prints one JSON line
per reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cfg_file, mix, seeds, controls, low, device="cuda",
             fault=None, calls=16):
    """One dict of readings per seed (see the module docstring); with
    `fault` (a name of ``faults``) the program runs with it planted.
    calls: transcription calls made per seed (a run compares one row of
    each, at most 16)."""
    import torch
    from benchmark import check, faults, program
    train = mix["entry"] == "train_step"
    cuda = torch.device(device).type == "cuda"
    check.full_f32_library()
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        kind = program.Train if train else program.Transcribe
        session = kind(cfg_file, mix, seed, device)
        if fault:
            (faults.TRAIN if train else faults.TRANSCRIBE)[fault](session)
        if train:
            session.warm()
        else:
            for i in range(calls):
                session.call(i)
        session.release()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        check.full_f32_library()
        control = n < controls
        if train:
            ref = check.train_reference(session, seed)
            got, where = check.gaps(session.readings, ref)
            g_ref = ref["grad_norm"]
            leaf = where["delta_gap_worst"]
            out = {"program": got, "worst_leaf": leaf,
                   "worst_leaf_grad_share": g_ref[leaf] / statistics.median(
                       g_ref.values())}
            if control:
                ctl = check.train_reference(session, seed, low)
                out[low] = check.gaps(ctl, ref)[0]
            out["loss"] = ref["loss"]
        else:
            precisions = ("f32", low) if control else ("f32",)
            got, served = check.transcribe_numbers(session, seed, precisions)
            out = {"program": got["f32"], "served_tokens": served}
            if control:
                out[low] = got[low]
        out.update(seed=seed, fault=fault,
                   seconds=time.perf_counter() - t0)
        yield out
        del session
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    from benchmark import core
    from speechmix_tpu_torch.ops import kernels
    _, cell, cfg_file, mix, _ = core.load_cell(args.workload)
    kernels.build_all()
    low = ("fp8" if mix["entry"] == "train_step" and mix["recipe"].get("bf16")
           else "tf32")
    for out in readings(cfg_file, mix, args.seeds, args.controls, low,
                        fault=args.fault):
        print(json.dumps({"cell": cell["name"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
