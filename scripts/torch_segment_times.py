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


def _smoke():
    """This checkout's chip_smoke.py, whatever tree the package comes from."""
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def worker(tree, shapes):
    import torch

    from graphem_rapids_torch.ops import segment as seg

    smoke = _smoke()
    here = os.path.dirname(os.path.dirname(seg.__file__))
    if not os.path.samefile(os.path.dirname(here), tree):
        raise RuntimeError(f"imported {seg.__file__}, not {tree}'s package")
    smi = smoke.nvidia_smi("name,power.limit")
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

        def timed(label, fn, check=None):
            if check is not None:
                row[f"{label}_bit_equal_cpu"] = bool(torch.equal(
                    check(base.clone()).cpu(), want))
            row[f"{label}_ms"] = smoke.cuda_ms(fn)
            row[f"{label}_back_to_back_ms"] = smoke.back_to_back_ms(fn)
            try:
                row[f"{label}_replayed_ms"] = smoke.replayed_ms(fn)
            except RuntimeError as exc:  # a library call not capturable
                row[f"{label}_replayed_ms"] = None
                row[f"{label}_capture_error"] = str(exc)[:200]

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
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    if args.worker:
        sys.path.insert(0, args.worker)
        return worker(args.worker, shapes)
    rc = 0
    for tree in [os.path.abspath(t) for t in (args.repo or [ROOT])]:
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--shapes", args.shapes], cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
