#!/usr/bin/env python3
"""The port's host prep with and without its threaded C helpers.

    python3 scripts/torch_host_prep.py                      # 1M and 10M
    python3 scripts/torch_host_prep.py --sizes 20000 --reps 1

For each size n, the graph of bench.py's build_scale_graph in numpy (a
ring plus 3n random chords, seed 0: chip_smoke.ring_chords_graph), then the
engine's host prep as GraphEmbedderTorch runs it on a card (the edge
extraction, then the binned tables, else the flat one; chip_smoke.host_prep)
with the C helpers of graphem_rapids_torch/native and with their plain
numpy versions, in turns (plain, C, C, plain, repeated ``--reps`` times).
Every output array must be equal in value and dtype between the two ways.
Prints one JSON line for the host (CPU model, CPU count, the CPUs the
process may use, the helpers' thread count, and the card's name and power
limit from nvidia-smi where there is one), then one per size with every
timing. Needs no card and no JAX; at 10M it holds ~20 GB of host memory.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from graphem_rapids_torch import native as fg  # noqa: E402


def card():
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def measure(n, reps):
    t0 = time.perf_counter()
    adj = cs.ring_chords_graph(n, 3 * n)
    graph_s = time.perf_counter() - t0
    secs = {True: [], False: []}
    outs = {}
    for _ in range(reps):
        for native in (False, True, True, False):
            edges, nb, t = cs.host_prep(adj, native)
            secs[native].append(t)
            outs[native] = (edges, nb)
            del edges, nb
    cs.assert_same(outs[True], outs[False], f"n={n}")
    edges, nb = outs[True]
    row = dict(n=n, E=len(edges),
               table="binned" if "buckets" in nb else "flat",
               overflow_pairs=int(len(nb["overflow"])), graph_s=graph_s)
    for way, native in (("native", True), ("plain", False)):
        for key in ("extract_s", "tables_s"):
            row[f"{way}_{key}"] = [t[key] for t in secs[native]]
        row[f"{way}_total_s_min"] = min(t["extract_s"] + t["tables_s"]
                                        for t in secs[native])
    print(json.dumps(row), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[1_000_000, 10_000_000])
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    print(json.dumps({
        "host": cs.cpu_model(), "cpu_count": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)),
        "threads": fg._nthreads(None), "card": card(),
        "library": str(fg.library()._name),
    }), flush=True)
    for n in args.sizes:
        measure(n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
