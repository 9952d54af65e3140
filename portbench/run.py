#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload skewed_1m.layout --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout that holds ``graphem_rapids_torch`` and
``BENCHMARK.json``, on a machine with the CUDA cards the cell asks for.
The last line of standard output is the result (one JSON object); the
numbers the check compared follow each with its limit as the last lines
of standard error. Without a card, or with too few, it prints no result
and exits with 2. Compiled modules are cached under ``build/pycache``.
``--control 1`` also reports the control's readings
(the reference in bfloat16 in the program's place), for setting limits.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_bytecode(root):
    """Cache compiled modules (torch's among them) inside the checkout, at
    a fixed path, and let them be written there even where the environment
    asks that none be: without it every run compiles every module it
    imports again, seconds of set-up."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(root, "build", "pycache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_bytecode(ROOT)
    sys.path.insert(0, ROOT)
    from portbench.harness import cell

    return cell.main(args, ROOT, T_START)


if __name__ == "__main__":
    sys.exit(main())
