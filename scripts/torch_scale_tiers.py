#!/usr/bin/env python3
"""The layout's main path at the JAX package's single-card scale tiers.

    python3 scripts/torch_scale_tiers.py                  # every tier
    python3 scripts/torch_scale_tiers.py --tiers ring_10m,ring_10m_setup
    python3 scripts/torch_scale_tiers.py --tiers skewed_1m --profile
    python3 scripts/torch_scale_tiers.py --shrink 100 --device cpu

The tiers, in this order (the graphs are the JAX package's experiment
scripts' own, with the same seed and draws, built here in numpy):

- ``skewed_1m``: ring + 3M zipf(1.6) chords on 1M vertices
  (experiments/bench_1m_skewed.py), hubs of tens of thousands of edges,
  the default init ('auto': the Chebyshev tier on the card);
- ``ring_10m``: ring + 25M random chords on 10M vertices
  (experiments/bench_10m.py), init='random';
- ``ring_10m_setup``: the same graph with init='auto', set-up only: the
  Chebyshev init at 10M, split into its device iteration and the rest;
- ``ring_30m``: ring + 66M chords on 30M vertices
  (experiments/bench_30m.py), binned tables, init='random';
- ``ring_100m``: ring + 15M chords on 100M vertices
  (experiments/bench_100m.py), init='random'.

The kernels are built first, once, so that no tier times a build. Each
tier runs in a process of its own, so that its host peak is its own and a
tier that fails leaves the others to run. It builds the graph (or
loads it from ``build/scale_tiers/``, where it is cached unless
``--no-cache``), constructs GraphEmbedderTorch with the JAX scripts'
settings (n_components=3, seed=0, L_min=10, k_attr=0.5, k_inter=0.1,
n_neighbors=15, sample_size=512), times a first run_layout(50) (the
eager first iteration, the capture, the replays and the positions read
back), then three blocks of 50 replayed iterations with
torch.cuda.synchronize() around each, as bench.py times its scale tier,
and keeps the best. It prints one JSON line: n and E, the table kind and
strategy, the fused refs and their slot count, K1's segments (n_seg) and
its launches a replayed iteration, the graph's build seconds, the set-up's
seconds and split (edge extraction, tables, spectral init, upload, the
rest), the first run's seconds, ms a warm iteration on the host's clock
and between CUDA events, edges x iterations / s, the device's peak and
reserved memory, the host's peak RSS, the bytes reckoned before the run,
the hub block plan's longest run, the positions' std, Spearman(radius,
degree) and the SHA-1 of their bytes (one seed, one layout: equal on every
run of the same tree). A tier that fails prints
its error beside the reckoned bytes, and the script exits non-zero. With
``--profile`` a tier also traces its Chebyshev init, run a second time, and
10 replayed iterations with torch.profiler (chip_smoke.py's
``profile_call``: device ms by kernel), each on a line of its own before
the tier's.

Needs one CUDA card (``--device cpu`` runs the same steps eagerly on the
host, for a rehearsal at ``--shrink``, which divides every vertex and chord
count; the recorded tiers run at 1). On an H100 the five tiers take about
15 minutes; the 100M tier holds tens of GB of host memory.
"""

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIERS = ("skewed_1m", "ring_10m", "ring_10m_setup", "ring_30m", "ring_100m")
# tier: (graph, vertices, chords, init, run the layout)
TIER_SPECS = {
    "skewed_1m": ("skewed", 1_000_000, 3_000_000, "auto", True),
    "ring_10m": ("ring", 10_000_000, 25_000_000, "random", True),
    "ring_10m_setup": ("ring", 10_000_000, 25_000_000, "auto", False),
    "ring_30m": ("ring", 30_000_000, 66_000_000, "random", True),
    "ring_100m": ("ring", 100_000_000, 15_000_000, "random", True),
}
ENGINE = dict(n_components=3, seed=0, verbose=False, L_min=10.0, k_attr=0.5,
              k_inter=0.1, n_neighbors=15, sample_size=512)
ZIPF_A = 1.6
ITERS = 50
BLOCKS = 3
CACHE = os.path.join(ROOT, "build", "scale_tiers")
# the kernels the tiers launch: K1 and the force accumulator
KERNELS = ["binfold", "segment_sum"]
# a tier's limit: the 100M tier takes about 4 minutes on an H100's host
TIER_TIMEOUT_S = 1800


def skewed_graph(n, chords, seed=0):
    """Ring + ``chords`` chords whose first endpoint is a zipf(1.6) rank
    (low ids become hubs): experiments/bench_1m_skewed.py's build_adj."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    za = np.minimum(rng.zipf(ZIPF_A, chords), n) - 1
    zb = rng.integers(0, n, chords)
    ch = np.column_stack([za, zb])
    ch = ch[ch[:, 0] != ch[:, 1]]
    e = np.concatenate([ring, ch])
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def ring_graph(n, chords, seed=0):
    """Ring + ``chords`` uniform chords, int64 draws and float32 values:
    the build_adj of experiments/bench_10m.py, bench_30m.py and
    bench_100m.py (the same procedure in each)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n, dtype=np.int64),
                            (np.arange(n, dtype=np.int64) + 1) % n])
    ch = rng.integers(0, n, (chords, 2), dtype=np.int64)
    ch = ch[ch[:, 0] != ch[:, 1]]
    e = np.concatenate([ring, ch])
    del ring, ch
    i = np.minimum(e[:, 0], e[:, 1])
    j = np.maximum(e[:, 0], e[:, 1])
    del e
    a = sp.coo_matrix((np.ones(len(i), np.float32), (i, j)),
                      shape=(n, n)).tocsr()
    del i, j
    a.data[:] = 1
    return a + a.T


BUILDERS = {"skewed": skewed_graph, "ring": ring_graph}


def graph(kind, n, chords, cache):
    """(adjacency, seconds, loaded from the cache)."""
    import scipy.sparse as sp

    path = os.path.join(CACHE, f"{kind}_{n}_{chords}.npz")
    t0 = time.perf_counter()
    if cache and os.path.exists(path):
        return sp.load_npz(path).tocsr(), time.perf_counter() - t0, True
    adj = BUILDERS[kind](n, chords)
    seconds = time.perf_counter() - t0
    if cache:
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.npz"
        sp.save_npz(tmp, adj, compressed=False)
        os.replace(tmp, path)
    return adj, seconds, False


def reckon_bytes(n, E, d=3, sample=512, k=16):
    """Bytes the engine should hold, reckoned from n and E before it is
    built. The ref and table slots are taken at their bound: 2E slots of
    the gather tables and 2E fused refs (at 1M the ring + chords graph
    holds 1.43E refs). Device: the tables and maps as int64 (tables, ref
    map, the refs' valid mask, the edge map, the edges, the edge order),
    the positions three times (the replayed buffer, the new positions, the
    eager iteration's), and the step's transient peak: the gathered
    neighbour positions with the spring's temporaries (four (slots, d)
    float32 blocks), the fused refs twice (made, then concatenated), the
    sample's E uniforms; K1's outputs are small. Host: the CSR (2E int32
    indices and float32 values), the (E, 2) int32 edges, the tables as
    built (int32 and int64, about half the device's static bytes) and the
    positions read back twice."""
    slots = refs = 2 * E
    static = 8 * slots + 9 * refs + 8 * E + 16 * E + 8 * E
    positions = 3 * 4 * n * d
    step = 4 * 4 * slots * d + 2 * 4 * refs * d + 4 * E \
        + 8 * sample * k * d * 4
    host = 8 * 2 * E + 8 * (n + 1) + 8 * E + static // 2 + 2 * 4 * n * d
    return {"device_static": static + positions, "device_step": step,
            "device_total": static + positions + step, "host": host}


def nvidia_smi():
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def host_peak_gib():
    """The process's peak resident set (ru_maxrss is in KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class Chebyshev:
    """Seconds of the Chebyshev init's device iteration (``_cheb_iterate``,
    synchronized) inside the block, beside the tier's own seconds from its
    log record."""

    def __enter__(self):
        import logging

        import torch

        from graphem_rapids_torch.ops import laplacian as lap

        self.lap, self.records, self.iterate_s = lap, [], 0.0
        self.saved = lap._cheb_iterate

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.saved(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.iterate_s += time.perf_counter() - t0
            return out

        class Keep(logging.Handler):
            def emit(handler, record):
                self.records.append(record)

        self.handler = Keep(logging.INFO)
        self.logger = logging.getLogger(lap.__name__)
        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        lap._cheb_iterate = timed
        return self

    def __exit__(self, *exc):
        self.lap._cheb_iterate = self.saved
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)

    def fields(self):
        """The tier's seconds, its device iteration and the rest (the
        symmetrized adjacency, the matvec plan, its upload, the start
        block); raises on a tier-down."""
        import logging

        down = [r.getMessage() for r in self.records
                if r.levelno >= logging.WARNING]
        if down:
            raise RuntimeError(f"the spectral init tiered down: {down}")
        runs = [r for r in self.records if hasattr(r, "chebyshev_seconds")]
        if not runs:
            return {}
        s = runs[0].chebyshev_seconds
        return dict(chebyshev_s=s, chebyshev_iterate_s=self.iterate_s,
                    chebyshev_rest_s=s - self.iterate_s,
                    spmv_overflow=runs[0].overflow,
                    spmv_overflow_pairs=runs[0].overflow_pairs)


def plan_runs(emb):
    """The hub block plan's block size, blocks and its longest run (the
    blocks of its widest hub, which the accumulator's static sum adds in
    order), where the engine has one."""
    import torch

    plan = emb._ops["ov_plan"]
    if plan is None:
        return {}
    _, runs = torch.unique_consecutive(plan["block_hub"], return_counts=True)
    return dict(plan_block=plan["block"], plan_blocks=int(runs.sum()),
                plan_hubs=int(runs.numel()), plan_longest_run=int(runs.max()))


def spearman_radius_degree(positions, adj):
    """Spearman(radius, degree) over every vertex, as
    experiments/bench_1m_skewed.py prints it."""
    from scipy.stats import spearmanr

    deg = np.diff(adj.indptr)
    radii = np.linalg.norm(positions, axis=1)
    return float(spearmanr(radii, deg).statistic)


def run_tier(tier, shrink, device, cache, profile=False):
    """One tier in this process; returns its JSON row."""
    import torch

    import chip_smoke as cs
    import graphem_rapids_torch as grt
    from graphem_rapids_torch.ops import knn_binfold as bf

    kind, n, chords, init, layout = TIER_SPECS[tier]
    n, chords = n // shrink, chords // shrink
    cuda = device == "cuda"
    row = dict(tier=tier, graph=kind, n=n, chords=chords, init=init,
               shrink=shrink, device=device, nvidia_smi=nvidia_smi(),
               torch=torch.__version__,
               reckoned=reckon_bytes(n, n + chords))
    adj, row["graph_build_s"], row["graph_cached"] = graph(kind, n, chords,
                                                           cache)
    row["reckoned"] = reckon_bytes(n, adj.nnz // 2)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with cs.program_split(cs.SETUP_SPANS) as split, Chebyshev() as cheb:
        t0 = time.perf_counter()
        emb = grt.GraphEmbedderTorch(adj, device=device, init=init, **ENGINE)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    split["other_s"] = setup_s - sum(split.values())
    refs = int(len(emb._nb["ref_edge"]))
    knn_refs = refs if emb._fused_refs_active else emb.n_edges
    T, _ = bf.params_for(emb._k_eff, emb.knn_recall_target)
    row.update(n=emb.n, E=emb.n_edges, table=emb.table_kind,
               strategy=emb._strategy, fused_refs=emb._fused_refs_active,
               ref_slots=refs, knn_refs=knn_refs,
               n_seg=(bf.segments(knn_refs, T)[1]
                      if emb._strategy == "binfold" else None),
               overflow_pairs=int(len(emb._nb["overflow"])),
               **plan_runs(emb),
               setup_s=setup_s, split=split, **cheb.fields(),
               setup_peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                                   if cuda else None))
    if profile and "chebyshev_s" in row:
        from graphem_rapids_torch.ops.laplacian import spectral_init

        cs.profile_call(
            "profile_init", tier, lambda: torch.ones(1, device=device) + 1,
            lambda: spectral_init(adj, 3, method="chebyshev", seed=0,
                                  device=device),
            row["chebyshev_s"] * 1e3, 1)
    if not layout:
        row["host_peak_rss_gib"] = host_peak_gib()
        return row
    t0 = time.perf_counter()
    emb.run_layout(ITERS, block_size=ITERS)
    row["first_run_s"] = time.perf_counter() - t0
    bf.knn_binfold.launches = 0
    best, best_dev = float("inf"), float("inf")
    for _ in range(BLOCKS):
        if cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        emb._iterate(ITERS)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            best_dev = min(best_dev, ev[0].elapsed_time(ev[1]) / ITERS)
        best = min(best, time.perf_counter() - t0)
        emb._iteration += ITERS
    pos = emb.positions
    row.update(
        k1_launches_per_iter=bf.knn_binfold.launches / (BLOCKS * ITERS),
        ms_per_iter=best / ITERS * 1e3,
        device_ms_per_iter=best_dev if cuda else None,
        edges_per_s=emb.n_edges * ITERS / best,
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if cuda else None),
        reserved_gib=torch.cuda.memory_reserved() / 2**30 if cuda else None,
        finite=bool(np.isfinite(pos).all()),
        # in float64: a float32 sum over 10^8 rows loses the low terms
        std=pos.astype(np.float64).std(axis=0, ddof=1).tolist(),
        spearman_radius_degree=spearman_radius_degree(pos, adj),
        # the same seed must give the same bits on every run
        positions_sha1=hashlib.sha1(pos.tobytes()).hexdigest(),
        host_peak_rss_gib=host_peak_gib())
    if not row["finite"]:
        raise RuntimeError("positions not finite")
    if profile:
        cs.profile_steps(emb, tier, best / ITERS * 1e3)
    return row


def worker(args):
    try:
        row = run_tier(args.worker, args.shrink, args.device, args.cache,
                       args.profile)
    except BaseException as exc:  # the error, beside the reckoned bytes
        kind, n, chords, _, _ = TIER_SPECS[args.worker]
        n, chords = n // args.shrink, chords // args.shrink
        print(json.dumps(dict(tier=args.worker, n=n, chords=chords,
                              error=f"{type(exc).__name__}: {exc}",
                              reckoned=reckon_bytes(n, n + chords),
                              host_peak_rss_gib=host_peak_gib())),
              flush=True)
        raise
    print(json.dumps(row), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiers", default=",".join(TIERS),
                    help="comma-separated tiers, run in the order given")
    ap.add_argument("--shrink", type=int, default=1,
                    help="divide every vertex and chord count (rehearsal)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-cache", dest="cache", action="store_false",
                    help=f"build every graph anew (no cache in {CACHE})")
    ap.add_argument("--profile", action="store_true",
                    help="trace the Chebyshev init and 10 replayed "
                         "iterations of each tier")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    tiers = [t for t in args.tiers.split(",") if t]
    unknown = sorted(set(tiers) - set(TIERS))
    if unknown:
        ap.error(f"unknown tiers {unknown}; the tiers are {TIERS}")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_scale_tiers: no CUDA device available",
                  file=sys.stderr)
            return 2
    print(nvidia_smi(), flush=True)
    # every kernel of the path, built before any tier is timed
    from graphem_rapids_torch import _build

    names = ["fastgraph"] + (KERNELS if args.device == "cuda" else [])
    t0 = time.perf_counter()
    _build.build(names)
    print(json.dumps(dict(build=names, seconds=time.perf_counter() - t0)),
          flush=True)
    failed = []
    for tier in tiers:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tier,
               "--shrink", str(args.shrink), "--device", args.device]
        if not args.cache:
            cmd.append("--no-cache")
        if args.profile:
            cmd.append("--profile")
        try:
            rc = subprocess.run(cmd, timeout=TIER_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            # a worker killed outright (out of host memory) printed nothing
            kind, n, chords, _, _ = TIER_SPECS[tier]
            n, chords = n // args.shrink, chords // args.shrink
            print(json.dumps(dict(tier=tier, failed=True, returncode=rc,
                                  reckoned=reckon_bytes(n, n + chords))),
                  flush=True)
            failed.append(tier)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
