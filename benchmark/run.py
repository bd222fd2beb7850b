"""The benchmark of speechmix_tpu_torch on the H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration, traffic mix and limits by name, builds (or
finds) the port's kernels, makes weights and inputs on the card from the
seed, warms up the cell's own shapes, times ``--seconds`` of back-to-back
calls or steps, checks the output against the plain reference, and prints
one JSON line.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark import core
    return core.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
