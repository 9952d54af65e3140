#!/usr/bin/env python3
"""Same seed, same layout? The main paths of several checkouts in turns on
one CUDA card: the drift between two runs of one seed, and the time per
iteration.

    python3 scripts/torch_determinism.py --repo OLD --repo NEW \\
        --repo NEW --repo OLD

Each ``--repo`` is a checkout holding ``graphem_rapids_torch``; each runs
in a process of its own, in the order given, and builds its kernels from
its own sources, so that two trees are compared inside one run on one card
(parent, change, change, parent). Without ``--repo`` the checkout this
script lives in runs. The phases are chip_smoke.py's (this checkout's),
driven through each tree's own package:

- the main paths: the 100K graph (four random Hamiltonian cycles, flat
  table; init='random', so that the host's eigsh stays out of the run)
  and the 1M graph (ring + 3M chords, binned tables and hub block plan;
  init='auto', the card's Chebyshev), each run for 50 iterations and then
  timed over five replayed runs of 50: ``ms_per_iter`` on the host's clock
  (to the positions read back) and ``device_ms_per_iter`` between CUDA
  events, each run's, and the card's SM clock, power and temperature
  after them (``nvidia_smi``);
- beside each, a second engine of the same seed and a third resumed from
  the second's checkpoint after 25 iterations (``seeded_twin``): the max
  abs difference of the starts, of the positions after 50 iterations and
  after all of them, and of the resumed run against the straight one;
- the Chebyshev init of the 1M graph twice on the card: its seconds and
  the max abs difference of the two starts;
- chip_smoke.py's phase 9 'pallas' case twice: the card's positions
  against each other and each run's error against the CPU.

Each line is one JSON object with the tree's path.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED_RUNS = 5
FIRST = 50  # iterations before the timed runs: the drift's first sample


def _smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _emit(tree, phase, **fields):
    print(json.dumps(dict(phase=phase, tree=tree, **fields)), flush=True)


def worker(tree):
    """Every measurement on the package of ``tree`` (first on sys.path)."""
    import numpy as np
    import torch

    import graphem_rapids_torch as grt
    from graphem_rapids_torch.ops.laplacian import spectral_init

    smoke = _smoke()
    if not os.path.samefile(os.path.dirname(os.path.dirname(grt.__file__)),
                            tree):
        raise RuntimeError(f"imported {grt.__file__}, not {tree}'s package")
    graphs = [("random_8_regular_100k", smoke.regular_union_graph(100_000),
               "random"),
              ("ring_chords_1m", smoke.ring_chords_graph(), "auto")]
    for label, adj, init in graphs:
        kw = dict(n_components=3, seed=0, verbose=False, **smoke.FORCE_PARAMS)
        t0 = time.perf_counter()
        emb = grt.GraphEmbedderTorch(adj, init=init, **kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        start = emb.positions
        mid = emb.run_layout(FIRST, block_size=10)
        ms, device_ms = [], []
        for _ in range(TIMED_RUNS):
            first = torch.cuda.Event(enable_timing=True)
            last = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            first.record()
            end = emb.run_layout(smoke.ITERS, block_size=10)
            last.record()
            ms.append((time.perf_counter() - t0) / smoke.ITERS * 1e3)
            torch.cuda.synchronize()
            device_ms.append(first.elapsed_time(last) / smoke.ITERS)
        _emit(tree, "main_run", graph=label, n=emb.n, E=emb.n_edges,
              table=emb.table_kind, init=init, init_s=init_s,
              iters=smoke.ITERS, ms_per_iter=ms,
              device_ms_per_iter=device_ms,
              nvidia_smi=smoke.nvidia_smi(
                  "clocks.sm,power.draw,temperature.gpu"))
        del emb
        run = dict(label=label, adj=adj, init=init, engine_kw={},
                   iters=FIRST + TIMED_RUNS * smoke.ITERS, start=start,
                   mid=mid, end=end)
        row, twin = smoke.seeded_twin(grt, run)
        del twin
        _emit(tree, "determinism", **row)
    adj = graphs[1][1]
    starts, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        starts.append(spectral_init(adj, 3, method="chebyshev", seed=0,
                                    device="cuda"))
        secs.append(time.perf_counter() - t0)
    _emit(tree, "chebyshev", graph=graphs[1][0], seconds=secs,
          max_diff=smoke.max_diff(*starts),
          bit_equal=bool(np.array_equal(*starts)))
    runs = []
    for _ in range(2):
        try:
            runs.append(smoke.phase_card_vs_cpu(grt, "pallas"))
        except AssertionError as exc:  # recorded: the tree's own result
            runs.append((None, str(exc)))
    if all(pos is not None for pos, _ in runs):
        _emit(tree, "card_vs_cpu_twice", strategy="pallas",
              max_abs_err=[err for _, err in runs],
              positions_max_diff=smoke.max_diff(runs[0][0], runs[1][0]),
              positions_bit_equal=bool(np.array_equal(runs[0][0],
                                                      runs[1][0])))
    else:
        _emit(tree, "card_vs_cpu_twice", strategy="pallas",
              failed=[err for pos, err in runs if pos is None])


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", action="append")
    ap.add_argument("--worker")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_determinism: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for repo in args.repo or [ROOT]:
        tree = os.path.abspath(repo)
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", tree], env=env, cwd=tree,
                              check=False)
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "error": proc.returncode}),
                  flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
