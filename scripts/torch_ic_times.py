#!/usr/bin/env python3
"""Time the port's IC spread estimate and greedy selection of several
checkouts in turns on one CUDA card.

    python3 scripts/torch_ic_times.py --repo OLD --repo NEW \\
        --repo NEW --repo OLD [--sweep] [--heavy-tail-only]

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
of 2 calls each, and on a 20,000-vertex graph of the same kind (k=3, p=0.1,
32 runs), warmed up once, 2 calls.

The heavy-tail plan first (chip_smoke's ``skewed_graph``, the benchmark's
``skewed_1m`` family: ring + 3M zipf(1.6) chords on 1M vertices, cap 7,
about 2.28M overflow in-edges, its 16 largest hubs vertices 0-15): for
three sets of 10 random seeds in 64 columns (W = 2) at p=0.1, the cascade
kernel back to back in its default mode, in forced push and in forced
dense (5 calls after one), each row with its steps, dense steps and the
SHA-1 of its active words (to hold two checkouts equal); the dense row's
``ms_per_dense_step`` is its ms over its steps (every step dense). Then
``estimated_influence`` on it as on the graphs below. Each estimate row
carries the program's counters ``ic.dense_steps`` and ``ic.dense_chunks``
over its timed calls (where the checkout has them). ``--heavy-tail-only``
stops there.

Before those, the cascade kernels alone, back to back (``chip_smoke``'s
``back_to_back_ms``) at the shapes of chip_smoke's phases 22 and 23 (the
100K and 1M plans, the 1M and 12M edge lists, 10 random seeds in 64
columns, p=0.1; the hub graph's first greedy chunk, B=2048, p=0.2), at
the first greedy chunk of the 2,000-vertex graph (B=2048, p=0.1), and on
a supercritical graph (the union of 12 random Hamiltonian cycles over
1,000,000 vertices, degree 24, so that p=0.1 reaches most of it; its plan
and its edge list; 10 random seeds in 64 columns), each at its own p and
at p=1. A checkout whose kernels take push lists gets them built once per
shape and runs its default mode; with ``--sweep`` it is also timed in
each forced mode and at each ``DENSE_BETA`` of ``BETAS`` (the kernel's
module's), and each variant's result is held against the default's
(active words, counts and steps equal). One JSON line per measurement.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program_counters(names):
    """The program's counters ``names`` (None where the checkout has no
    tracing module)."""
    try:
        from graphem_rapids_torch.utils import tracing
    except ImportError:
        return None
    got = tracing.snapshot()["counters"]
    return {k: got.get(k, 0) for k in names}


COUNTERS = ("ic.cascades", "ic.dense_steps", "ic.dense_chunks")


def estimate_times(cs, grt, tag, label, adj, warm, reps):
    """Wall seconds of ``reps`` estimates after ``warm`` warm-ups, the peak
    device memory of the first warm-up, the program's counters over the
    timed calls, and the profiler row."""
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
    before = program_counters(COUNTERS)
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spread = estimate()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    after = program_counters(COUNTERS)
    counters = after and {k: after[k] - before[k] for k in after}
    print(json.dumps(dict(tag, phase="ic_estimate", graph=label,
                          seconds=wall, spread=spread, peak_mem_gib=peak,
                          counters=counters)), flush=True)
    cs.profile_call("profile_ic", label, estimate, estimate,
                    min(wall) * 1e3, 1)


# the DENSE_BETA values of the sweep
BETAS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5)


def heavy_tail_times(cs, tag, adj):
    """The cascade kernel on the heavy-tail plan, per cascade, for three
    sets of 10 random seeds (64 columns, p=0.1): back to back in the
    default mode, forced push and forced dense, results held equal."""
    import numpy as np
    import torch

    from graphem_rapids_torch.influence import _as_edges_and_n
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_sim as tic

    key = torch.tensor(cs.IC_KEY, dtype=torch.int64, device="cuda")
    edges, n = _as_edges_and_n(adj)
    plan = tic.build_cascade_plan(edges, n, "cuda")
    del edges
    lists = plan["push"]
    chunks = lists[3] if len(lists) == 4 else None  # the chunk list, if any
    head = (plan["table"], plan["ov_ptr"], plan["ov_src"])
    for s in range(3):
        seeds = np.random.default_rng(s).choice(n, 10, replace=False)
        mask = torch.zeros((n, 64), dtype=torch.bool, device="cuda")
        mask[torch.as_tensor(seeds, device="cuda")] = True
        args = head + (icc.pack_columns(mask), key, icc.coin_threshold(0.1),
                       200, 64, None, lists)
        want = None
        for mode in ("auto", "push", "dense"):
            stats = {}
            got = icc.ic_cascade(*args, mode=mode, stats=stats)
            ms = cs.back_to_back_ms(
                lambda m=mode: icc.ic_cascade(*args, mode=m), reps=5,
                warmup=1)
            want = got if want is None else want
            steps, dense = int(got[2]), int(stats["dense_steps"])
            row = dict(tag, phase="kernel_time", kernel="ic_cascade",
                       graph="skewed_1m", seed_set=s, p=0.1, variant=mode,
                       steps=steps, dense_steps=dense, back_to_back_ms=ms,
                       cap=int(plan["table"].shape[1]),
                       overflow=int(plan["ov_src"].shape[0]),
                       chunks=None if chunks is None else int(chunks.shape[0]),
                       spread=float(got[1].float().mean()),
                       active_sha1=hashlib.sha1(
                           got[0].cpu().numpy().tobytes()).hexdigest(),
                       equal=all(torch.equal(g, w)
                                 for g, w in zip(got, want)))
            if mode == "dense":
                row["ms_per_dense_step"] = ms / max(steps, 1)
            print(json.dumps(row), flush=True)
    del plan, head, lists, chunks
    torch.cuda.empty_cache()


def kernel_times(cs, tag, sweep):
    """Back-to-back ms of the checkout's cascade kernels at the shapes of
    chip_smoke's phases 22 and 23 and at a 2,000-vertex greedy chunk, at
    each shape's p and at p=1."""
    import torch

    from graphem_rapids_torch.influence import _as_edges_and_n
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_scatter as ics
    from graphem_rapids_torch.ops import ic_sim as tic

    key = torch.tensor(cs.IC_KEY, dtype=torch.int64, device="cuda")
    adj1m = cs.ring_chords_graph()
    cases = [("ic_cascade", c) for c in cs.ic_cases(
        [("random_8_regular_100k", cs.regular_union_graph(100_000)),
         ("ring_chords_1m", adj1m)])]
    adj12m = cs.ring_chords_graph(cs.SCATTER_N, 3 * cs.SCATTER_N)
    cases += [("ic_scatter", c) for c in cs.ic_cases(
        [("ring_chords_1m", adj1m), ("ring_chords_12m", adj12m)])]
    del adj1m, adj12m
    # supercritical: p * degree = 2.4
    adj24 = cs.regular_union_graph(1_000_000, cycles=12)
    for kernel in ("ic_cascade", "ic_scatter"):
        cases.append((kernel, cs.ic_cases([("regular_24_1m", adj24)])[0]))
    del adj24
    # the first greedy chunk on the 2,000-vertex graph of chip_smoke's
    # greedy phase: candidates 0..63, 32 runs each, no hub overflow
    adj2k = cs.regular_union_graph(2000)
    mask = torch.zeros((2000, 64), dtype=torch.bool, device="cuda")
    mask[torch.arange(64), torch.arange(64)] = True
    cases.append(("ic_cascade", ("greedy_chunk_2000", adj2k,
                                 mask.repeat_interleave(32, dim=1), 0.1, 32)))
    pushing = hasattr(ics, "edge_push_lists")
    for kernel, (label, adj, mask, p, runs) in cases:
        edges, n = _as_edges_and_n(adj)
        words = icc.pack_columns(mask)
        B = mask.shape[1]
        if kernel == "ic_cascade":
            plan = tic.build_cascade_plan(edges, n, "cuda")
            head = (plan["table"], plan["ov_ptr"], plan["ov_src"])
            fn, lists = icc.ic_cascade, plan.get("push")
        else:
            head = tic.directed_edges(edges, "cuda")
            fn = ics.ic_scatter
            lists = ics.edge_push_lists(*head, n) if pushing else None
        del edges
        for pp in (p, 1.0):
            args = head + (words, key, icc.coin_threshold(pp), 200, B, runs)
            if lists is not None:
                args += (lists,)
            mod = icc if kernel == "ic_cascade" else ics
            variants = [("default", {})]
            if sweep and pushing:
                variants += [(m, dict(mode=m)) for m in ("push", "dense")]
                variants += [(f"beta={b}", dict(beta=b)) for b in BETAS]
            want = None
            for name, kw in variants:
                beta = getattr(mod, "DENSE_BETA", None)
                if "beta" in kw:
                    mod.DENSE_BETA = kw.pop("beta")
                try:
                    stats = dict(stats={}) if pushing else {}
                    got = fn(*args, **kw, **stats)
                    ms = cs.back_to_back_ms(lambda kw=kw: fn(*args, **kw))
                finally:
                    if beta is not None:
                        mod.DENSE_BETA = beta
                want = got if want is None else want
                row = dict(tag, phase="kernel_time", kernel=kernel,
                           graph=label, p=pp, variant=name,
                           steps=int(got[2]), back_to_back_ms=ms,
                           equal=all(torch.equal(g, w)
                                     for g, w in zip(got, want)))
                if pushing:
                    row["dense_steps"] = int(stats["stats"]["dense_steps"])
                print(json.dumps(row), flush=True)
        del head, words, lists
        torch.cuda.empty_cache()


def worker(repo, sweep=False, heavy_tail_only=False):
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
    adj = cs.skewed_graph()
    heavy_tail_times(cs, tag, adj)
    estimate_times(cs, grt, tag, "skewed_1m", adj, 2, 5)
    del adj
    if heavy_tail_only:
        return 0
    kernel_times(cs, tag, sweep)
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
               200),
              ("regular_union_20000", cs.regular_union_graph(20_000), 3,
               0.1, 200))
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
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--heavy-tail-only", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.sweep, args.heavy_tail_only)
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
                              "--worker", repo]
                             + ["--sweep"] * args.sweep
                             + ["--heavy-tail-only"] * args.heavy_tail_only,
                             env=env,
                             check=False)
        if res.returncode != 0:
            print(f"torch_ic_times: {repo} failed ({res.returncode})",
                  file=sys.stderr)
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
