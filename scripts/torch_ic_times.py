#!/usr/bin/env python3
"""Time the port's IC spread estimate and greedy selection of several
checkouts in turns on one CUDA card.

    python3 scripts/torch_ic_times.py --repo OLD --repo NEW \\
        --repo NEW --repo OLD

Each ``--repo`` is a checkout holding ``graphem_rapids_torch``; each runs
in a process of its own, in the order given (parent, change, change,
parent), so two versions are compared inside one run on one card. Without
``--repo`` the checkout this script lives in is timed. A checkout's
cascade kernels (``csrc/ic_cascade.cu``, ``csrc/ic_scatter.cu``, where it
has them) are built first, into its own build directory.

For the 100K 8-regular graph and the 1M ring + chords graph of
``chip_smoke.py``: ``estimated_influence(p=0.1, num_sims=64)`` of 10
random vertices (chip_smoke's ``spread_random`` seeds), warmed up twice,
then the wall seconds of 5 calls (each ending in a synchronize), then the
``profile_ic`` row of ``chip_smoke.profile_call``: device ms by kernel and
the host's launch calls of one call. The same for the 12M ring + chords
graph of chip_smoke's phase 23 (past the cascade table's budget: the
scatter path), warmed up once, 3 timed calls, with the peak device memory
of the first; a checkout that runs out of device memory there prints an
``error`` line instead and goes on. Then ``greedy_seed_selection`` on
chip_smoke's hub graph (k=3, p=0.2, 32 runs) and on the 2,000-vertex graph
of its greedy phase (k=5, p=0.1, 32 runs), warmed up once, wall seconds
of 2 calls each. One JSON line per measurement.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def estimate_times(cs, grt, tag, label, adj, warm, reps):
    """Wall seconds of ``reps`` estimates after ``warm`` warm-ups, the peak
    device memory of the first warm-up, and the profiler row."""
    import numpy as np
    import torch

    n = adj.shape[0]
    seeds = np.random.default_rng(0).choice(n, 10, replace=False).tolist()

    def estimate():
        return grt.estimated_influence(adj, seeds, p=0.1, num_sims=64)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warm):
        estimate()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spread = estimate()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    print(json.dumps(dict(tag, phase="ic_estimate", graph=label,
                          seconds=wall, spread=spread,
                          peak_mem_gib=peak)), flush=True)
    cs.profile_call("profile_ic", label, estimate, estimate,
                    min(wall) * 1e3, 1)


def worker(repo):
    """Time one checkout; the port comes from ``repo``, the graphs and
    the profiler row from this script's chip_smoke.py."""
    sys.path.insert(0, os.path.abspath(repo))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import graphem_rapids_torch as grt
    from graphem_rapids_torch import _build

    tag = dict(repo=os.path.abspath(repo))
    kernels = [name for name in ("ic_cascade", "ic_scatter")
               if (_build.CSRC_DIR / f"{name}.cu").exists()]
    if kernels:
        _build.build(kernels, force=True)
    graphs = (("random_8_regular_100k", cs.regular_union_graph(100_000)),
              ("ring_chords_1m", cs.ring_chords_graph()))
    for label, adj in graphs:
        estimate_times(cs, grt, tag, label, adj, 2, 5)
    adj = cs.ring_chords_graph(cs.SCATTER_N, 3 * cs.SCATTER_N)
    try:
        estimate_times(cs, grt, tag, "ring_chords_12m", adj, 1, 3)
    except torch.cuda.OutOfMemoryError as exc:
        print(json.dumps(dict(tag, phase="ic_estimate",
                              graph="ring_chords_12m",
                              error=f"out of device memory: {exc}")),
              flush=True)
    del adj
    torch.cuda.empty_cache()
    greedy = (("hub", cs.hub_graph(), 3, 0.2, 50),
              ("regular_union_2000", cs.regular_union_graph(2000), 5, 0.1,
               200))
    for label, adj, k, p, iters in greedy:
        def select():
            return grt.greedy_seed_selection(adj, k, p=p,
                                             iterations_count=iters,
                                             num_sims=32, seed=0)

        select()
        wall = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seeds, evals = select()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        print(json.dumps(dict(tag, phase="greedy_time", graph=label,
                              seconds=wall, seeds=seeds, evaluations=evals)),
              flush=True)
    return 0


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", action="append")
    ap.add_argument("--worker")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    import torch

    if not torch.cuda.is_available():
        print("torch_ic_times: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import nvidia_smi

    print(nvidia_smi("name,power.limit"), flush=True)
    for repo in args.repo or [ROOT]:
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", repo], env=env, check=False)
        if res.returncode != 0:
            print(f"torch_ic_times: {repo} failed ({res.returncode})",
                  file=sys.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
