#!/usr/bin/env python3
"""The accumulator's dynamic form on one CUDA card, at the engines' shapes,
for several checkouts in turns.

    python3 scripts/torch_segment_times.py --repo OLD --repo NEW \\
        --repo NEW --repo OLD

Each ``--repo`` is a checkout holding ``graphem_rapids_torch``; each runs
in a process of its own, in the order given, and builds its kernels from
its own sources. Without ``--repo`` the checkout this script lives in
runs. The calls are made from a seed as ``intersection_forces`` makes
them: the endpoints of S=512 sampled edges, each repeated k times, then
those of k neighbour edges each, of a union of four random Hamiltonian
cycles (d=3 values):

- ``main_100k``: k=16 (30,720 terms) into 100,000 rows;
- ``main_1m``: k=16 into 1,000,000 rows;
- ``approx_100k``, ``approx_1m``: k=48 (98,304 terms);
- ``spring_100k``: the unplanned ``spring_forces`` of the 100K graph,
  2E = 799,968 terms (the tiled form).

For each call and tree: ``segment_sum`` (whatever form the tree takes) per
call (each timed alone between CUDA events, the median of 20), back to back
(events around 20 calls) and replayed (a CUDA graph of 20 calls, replayed
five times), and its result held bit-equal to the CPU's ``index_add_``;
where the tree has them, the cluster kernel and the tiled form (tile sort
and sum) apart, replayed; ``index_add_`` on the card (float atomics) and
under ``torch.use_deterministic_algorithms(True)`` (a sorted
``index_put_``, the setting restored after each call), per call and
replayed, and whether each is bit-equal to the CPU's. Each line is one JSON
object with the tree's path, the card's name and power limit.

The static form (``segment_sum_sorted``) on the sums of the hub block
plans and a COO tail, as the engine and its spectral init build them (the
sorted keys cached under ``build/segment_times/``; random values from a
seed, rows from zero):

- ``skewed_step``: the layout step's plan of the 1M heavy-tail graph
  (scripts/torch_scale_tiers.py's ``skewed_1m``: 84,827 blocks of 32 onto
  14,996 hubs, the longest run 22,841), d=3;
- ``skewed_cheb``: its Chebyshev SpMV's plan, s=8 columns;
- ``ring_1m_step``: the 1M ring graph's step plan (bench.py's scale
  graph, chip_smoke.py's), d=3;
- ``ring_10m_step``: ``ring_10m``'s step plan (runs of 1-2), d=3;
- ``ring_1m_coo``: the 1M ring graph's overflow pairs as a COO tail (the
  step's sum where no block plan is built: keys the pairs' rows, into
  1,000,000 rows), d=3.

Each the same timings and checks, ``index_add_``'s too, its longest run
and both bounds (bytes: keys, values and touched rows read, rows written,
at 3.35 TB/s; order: the longest run's dependent adds at 4 cycles and the
card's top SM clock).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"main_100k": (100_000, 16), "main_1m": (1_000_000, 16),
          "approx_100k": (100_000, 48), "approx_1m": (1_000_000, 48),
          "spring_100k": (100_000, None)}
S = 512
# static call: (graph, plan, columns)
STATIC = {"skewed_step": ("skewed", "step", 3),
          "skewed_cheb": ("skewed", "cheb", 8),
          "ring_1m_step": ("ring_1m", "step", 3),
          "ring_10m_step": ("ring_10m", "step", 3),
          "ring_1m_coo": ("ring_1m", "coo", 3)}
PLAN_CACHE = os.path.join(ROOT, "build", "segment_times")
MEM_BYTES_PER_S = 3.35e12
FADD_CYCLES = 4


def make_call(n, k, seed=0):
    """(ids int64, values (M, 3) float32, rows) made from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    e = np.concatenate([np.column_stack([p, np.roll(p, -1)]) for p in
                        (rng.permutation(n) for _ in range(4))])
    if k is None:
        ids = np.concatenate([e[:, 0], e[:, 1]])
    else:
        ci = np.repeat(rng.choice(len(e), S, replace=False), k)
        cj = rng.integers(0, len(e), S * k)
        ids = np.concatenate([e[ci, 0], e[ci, 1], e[cj, 0], e[cj, 1]])
    values = rng.standard_normal((len(ids), 3)).astype(np.float32)
    return ids.astype(np.int64), values, n


def static_plan(name):
    """(keys, rows) of a static call: the sorted keys of its plan, built as
    the engine (the layout step) or its spectral init (the SpMV) builds it
    (chip_smoke.hub_plan, chip_smoke.binned_tables for a COO tail), and the
    rows of its output; cached as .npz."""
    import numpy as np

    path = os.path.join(PLAN_CACHE, f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return f["keys"], int(f["rows"])
    smoke = _smoke()
    graph, which, _ = STATIC[name]
    if graph == "skewed":
        adj = smoke.skewed_graph()
    elif graph == "ring_10m":
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import torch_scale_tiers as tiers

        adj = tiers.ring_graph(10_000_000, 25_000_000)
    else:
        adj = smoke.ring_chords_graph(1_000_000, 3_000_000)
    if which == "coo":
        keys = np.asarray(smoke.binned_tables(adj)["overflow"][:, 0])
        rows = adj.shape[0]
    else:
        plan = smoke.hub_plan(adj, spmv=which == "cheb")
        keys = np.asarray(plan["block_hub"])
        rows = len(plan["hub_ids"])
    keys = keys.astype(np.int64)
    if len(keys) and (np.diff(keys) < 0).any():
        raise AssertionError(f"{name}: keys not ascending")
    os.makedirs(PLAN_CACHE, exist_ok=True)
    np.savez(path, keys=keys, rows=rows)
    return keys, rows


def static_worker(tree, names, smoke, seg, smi, clock_hz):
    """The static form on each named call: times, checks and bounds."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    for name in names:
        keys_np, rows = static_plan(name)
        d = STATIC[name][2]
        runs = np.diff(np.flatnonzero(np.r_[True, keys_np[1:] !=
                                            keys_np[:-1], True]))
        N, H = len(keys_np), len(runs)
        keys = torch.from_numpy(keys_np).to(dev)  # int64, as uploaded
        gen = torch.Generator().manual_seed(2)
        values = torch.randn(N, d, generator=gen).to(dev)
        base = torch.zeros(rows, d, device=dev)
        want = base.cpu().index_add_(0, keys.cpu(), values.cpu())
        o = base.clone()
        io_bytes = N * 8 + N * d * 4 + 2 * H * d * 4
        row = dict(phase="segment_times_static", tree=tree, call=name,
                   terms=N, rows=rows, touched_rows=H, d=d,
                   longest_run=int(runs.max()),
                   runs_over_64=int((runs >= 64).sum()), nvidia_smi=smi,
                   io_bytes=io_bytes,
                   bytes_bound_ms=io_bytes / MEM_BYTES_PER_S * 1e3,
                   order_bound_ms=int(runs.max()) * FADD_CYCLES / clock_hz
                   * 1e3)
        _timings(row, smoke, "static",
                 lambda: seg.segment_sum_sorted(o, keys, values),
                 lambda b: seg.segment_sum_sorted(b, keys, values), want,
                 base)
        _timings(row, smoke, "index_add",
                 lambda: o.index_add_(0, keys, values),
                 lambda b: b.index_add_(0, keys, values), want, base)
        det = smoke.deterministic(lambda x: x.index_add_(0, keys, values))
        _timings(row, smoke, "deterministic_index_add", lambda: det(o), det,
                 want, base)
        print(json.dumps(row), flush=True)
        del o, base, values, keys


def _timings(row, smoke, label, fn, check, want, base):
    """``fn``'s per-call, back-to-back and replayed ms into ``row``, and
    whether ``check`` on a copy of ``base`` is bit-equal to ``want``."""
    import torch

    row[f"{label}_bit_equal_cpu"] = bool(torch.equal(
        check(base.clone()).cpu(), want))
    row[f"{label}_ms"] = smoke.cuda_ms(fn)
    row[f"{label}_back_to_back_ms"] = smoke.back_to_back_ms(fn)
    try:
        row[f"{label}_replayed_ms"] = smoke.replayed_ms(fn)
    except RuntimeError as exc:  # a library call not capturable
        row[f"{label}_replayed_ms"] = None
        row[f"{label}_capture_error"] = str(exc)[:200]


def _smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def worker(tree, shapes, statics):
    import torch

    from graphem_rapids_torch.ops import segment as seg

    smoke = _smoke()
    here = os.path.dirname(os.path.dirname(seg.__file__))
    if not os.path.samefile(os.path.dirname(here), tree):
        raise RuntimeError(f"imported {seg.__file__}, not {tree}'s package")
    smi = smoke.nvidia_smi("name,power.limit")
    clock_hz = float(smoke.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    static_worker(tree, statics, smoke, seg, smi, clock_hz)
    dev = torch.device("cuda")
    for name in shapes:
        ids_np, values_np, rows = make_call(*SHAPES[name])
        ids = torch.from_numpy(ids_np).to(dev)
        values = torch.from_numpy(values_np).to(dev)
        base = torch.randn(rows, 3, generator=torch.Generator().manual_seed(
            1)).to(dev)
        want = base.cpu().index_add_(0, ids.cpu(), values.cpu())
        o = base.clone()
        row = dict(phase="segment_times", tree=tree, call=name,
                   terms=len(ids_np), rows=rows, nvidia_smi=smi)

        def timed(label, fn, check):
            _timings(row, smoke, label, fn, check, want, base)

        timed("segment_sum", lambda: seg.segment_sum(o, ids, values),
              lambda b: seg.segment_sum(b, ids, values))
        if hasattr(seg, "segment_sum_cluster") and \
                len(ids) <= seg.cluster_max_terms(dev):
            timed("cluster", lambda: seg.segment_sum_cluster(o, ids, values),
                  lambda b: seg.segment_sum_cluster(b, ids, values))
        keys, perm, T, _, mask = seg.sort_tiles(ids, rows)
        row["tiled_replayed_ms"] = smoke.replayed_ms(
            lambda: _tiled(seg, o, ids, values, rows))
        row["tile_sort_replayed_ms"] = smoke.replayed_ms(
            lambda: seg.sort_tiles(ids, rows))
        row["tile_sum_replayed_ms"] = smoke.replayed_ms(
            lambda: seg.segment_sum_cuda(o, keys, values, perm, tiles=T,
                                         mask=mask))
        timed("index_add", lambda: o.index_add_(0, ids, values),
              lambda b: b.index_add_(0, ids, values))
        det = smoke.deterministic(lambda x: x.index_add_(0, ids, values))
        timed("deterministic_index_add", lambda: det(o), det)
        print(json.dumps(row), flush=True)
        del o, base


def _tiled(seg, out, ids, values, rows):
    """The tiled form: the tile sort, then the sum."""
    keys, perm, T, _, mask = seg.sort_tiles(ids, rows)
    return seg.segment_sum_cuda(out, keys, values, perm, tiles=T, mask=mask)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", action="append")
    ap.add_argument("--worker")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--static", default=",".join(STATIC))
    args = ap.parse_args(argv)
    shapes = [x for x in args.shapes.split(",") if x]
    statics = [x for x in args.static.split(",") if x]
    if args.worker:
        sys.path.insert(0, args.worker)
        return worker(args.worker, shapes, statics)
    sys.path.insert(0, ROOT)
    for name in statics:  # built once, before any tree is timed
        static_plan(name)
    rc = 0
    for tree in [os.path.abspath(t) for t in (args.repo or [ROOT])]:
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--shapes", args.shapes, "--static", args.static],
            cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
