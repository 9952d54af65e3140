#!/usr/bin/env python3
"""Smoke run of graphem_rapids_torch on one CUDA card.

    python3 chip_smoke.py               # the phases below, one JSON line each
    python3 chip_smoke.py --profile     # also a torch.profiler breakdown of
                                        # 10 iterations of each main-path,
                                        # quick-start and sharded graph (with
                                        # the host's launch calls), and of
                                        # one IC call on each quick-start
                                        # graph and on phase 23's, and the
                                        # sharded diagnostics of phases 11
                                        # and 13
    python3 chip_smoke.py --multi-card  # phases 1, 2 and 13 only (a host
                                        # with several cards; with --profile
                                        # each rank also times and traces
                                        # the 1M graph and K3's ring)

Phases:
1. device: the card's name, and its power limit and clocks from nvidia-smi;
2. build: every kernel of graphem_rapids_torch/csrc, built from source,
   one nvcc per source, and the host helpers' library (csrc/fastgraph.c,
   the host compiler), all started together;
3. K1 against its plain version: the bin-fold kernel and its plain
   PyTorch version on the same inputs, at the main path's shapes (S=512,
   d=3, T=2048, G=24, against 800,000 and 5,699,741 refs, 1 in 40 at the
   1e30 pad), at the toolkit's (S=512, d=3 against the refs of
   phase 15's graph, read from an engine built as run_benchmark builds
   it) and S=416, small ragged and G-clamped cases at d=2 and d=4
   with fewer work units than resident blocks, n_super=1, d=1 with ragged
   pieces, d=8 (8 queries per block), and refs repeating every G*T
   positions, so that every piece boundary of the plan cuts exact ties.
   Bins must be bit-equal with identical indices; after top-k the
   distances must be equal and the neighbour sets identical. The plain
   fold runs 64 query rows at a time. Then ptxas's registers and spills at
   d=3 (no spill allowed), and at both shapes the kernel's time (the
   median of 20 calls, each timed alone between CUDA events, which also
   counts the card waiting for the host to enqueue the call, as in every
   earlier run), its back-to-back time (CUDA events around 20 calls
   launched back to back: the card's time), the plain version's, the
   instruction bound, and the S=416 wave diagnostic (its back-to-back time
   over S=512's);
4. K2 against its plain version: the exact tiled kNN kernel and its plain
   version at S=512, d=3, k=16 against the midpoint counts of both graphs
   (399,984 and 3,999,991 refs), a ragged ref count, duplicated refs
   (exact ties), ties at distance 0 across every slice boundary of the
   plan, 1e30 pad rows leaving fewer than k refs, k=1, k=33 with S not a
   multiple of the 32-query block, k=128 (also over many query blocks),
   one query over many slices, one slice, d=1, 2, 4, 8 and the generic
   path at d=11. Indices must be identical and values bit-equal. Then
   ptxas's registers and spills at d=3, k=16, and at both shapes the
   kernel's time and its back-to-back time (as in phase 3), the plain
   version's, the instruction bound, and as the library yardstick
   the port's knn_exact (difference-form distances and one torch.topk:
   two PyTorch calls, which the 'pallas' path never runs; at 1M an (S, E)
   block of 8.2 GB, and an out-of-memory there is reported, not raised);
5. main path, 100K vertices: GraphEmbedderTorch on a random 8-regular
   graph (union of four random Hamiltonian cycles, seed 0), the force
   parameters of bench.py, scipy spectral init, then run_layout(50). On the
   card run_layout replays one captured iteration as a CUDA graph (the
   warm-up runs the first iteration eagerly and captures); the launch
   counts are the replays', and the K1 shapes are recorded from the
   warm-up on, so that the capture's shapes (the replayed ones) are
   checked;
6. main path, 1M vertices: ring + 3M random chords as in bench.py,
   init='auto', which is the Chebyshev tier on the card from 500,000
   vertices (main_setup prints init_s, the Chebyshev seconds, the Ritz
   values, the SpMV's overflow form and the set-up's peak memory, and
   fails if the init tiered down), then run_layout(50); binned table +
   overflow plan. Both main paths fail if K1 runs at a shape that phase 3
   did not check. Each main_setup line also splits init_s by the program's
   spans into the edge extraction, the tables, the spectral init, the
   step's upload and the rest, counts the host helpers' calls (phase 21), and fails if the
   extraction and the sorts did not run in C;
7. quick start, both graphs: create_graphem(backend='cuvs') (the 'pallas'
   strategy, K2), run_layout(50) timed, graphem_seed_selection (20 more
   iterations), then estimated_influence of the seeds and of 10 random
   vertices at p=0.1 over 64 runs, and the exact gates p=0 (exactly the
   seeds) and p=1 (exactly the seeds' connected components); the first
   estimate's ic_seconds split by the program's spans into the edge
   extraction, the cascade plan's host build, its upload, and the device
   part (push lists, cascade, the wait for the counts);
   the four cascades must be four ic_cascade launches;
8. greedy: greedy_seed_selection on a small hub graph, the same seeds on
   the card and on the CPU, on the gather path and on the scatter path's
   full sweep (TABLE_BUDGET_SLOTS patched to 0: three ic_scatter launches,
   one chunk a round, and no ic_cascade launch); on the two-star graph
   (centres 0 and 201, k=2, p=1, 4 runs) the card and the CPU must both
   take [0, 201], the full sweep's seeds (CELF caches marginal gains);
   then on a 2,000-vertex graph (four random Hamiltonian cycles, k=5,
   p=0.1, 32 runs) through the cascade kernel and through its plain
   version on the card: the same seeds and evaluations, both timed; then
   on a 20,000-vertex graph of the same kind (k=3), timed, with its
   ic_cascade launches and one build of the plan's push lists (the
   scatter path's greedy, too, builds its lists once);
9. card against CPU: a small graph, 5 injected-sample steps with
   knn_strategy='binfold', 'pallas' and 'approx', and 'binfold' with
   ref_order='slot', on the card and on the CPU, allclose (the 'pallas'
   case runs again in phase 24);
10. K3 against its plain version: one ring hop (the fold of a rank's ref
    tile, ids rank * R_pad + p, and the min-merge with the carry) by the
    kernel and by ring_fold_reference, at hop 0 and at later hops with a
    carry, each line with the hop's fold plan (units, blocks, pieces): one
    rank at S=512 against the main path's two shapes (800,000 and
    5,699,741 fused refs), the 1M graph's refs over 4 virtual ranks
    (S_loc=128) and over 8 (S_loc=64), one rank on 64 queries, ragged
    tiles with 1e30 pads at S=500 for d=2 and d=4, a tile duplicated on
    two ranks (every bin ties; the carry must win), fewer units than
    resident blocks, d=1 and d=8 (8 queries a thread), refs repeating
    every G*T positions on every rank (ties across every piece boundary
    and against the carry, which must come out unchanged: the 1M shape on
    64 queries and a 4-rank tile at hop 3), and merges in place on the
    carry (as the ring runs from its second hop), at the one-rank 1M
    shape among others. The plain version runs on 64 query rows at a
    time. Bins and ids must be bit-equal. The whole virtual ring
    (ring_binfold_topk_virtual) with the kernel against the same with the
    plain version: equal distances, identical neighbour sets. Then
    ptxas's registers and spills of the ring kernel at d=3 (no spill
    allowed), and the kernel's time per call and back to back (with the
    scratch made once, as the ring does, and with a scratch of its own
    each call) beside its bound and the plain version's on all the
    queries at three shapes: the one-rank 1M shape
    (S_loc=512, R_pad=5,701,632), 64 queries against the same refs, and
    a four-card tile (S_loc=128, E_loc=1,424,936, offset 3 * R_pad) merged
    in place into a carry. Then the whole-ring entry (one launch per ring,
    the sharded path's) as a ring of one rank at the one-rank 1M shape,
    bit-equal to the plain hop, timed per call and back to back in turns
    with the per-hop entry (ring, hop, hop, ring): the ms of the
    {"kernels": ...} line are the whole ring's;
11. the sharded path: distributed_init starts a one-rank NCCL group (a
    file:// store in a temporary directory); ShardedGraphEmbedder with
    knn_comm='ring_pallas' on both graphs (at 100K with init='chebyshev',
    whose start must equal phase 14's single-card Chebyshev modulo column
    signs at atol=1e-4), warm-up, then 50 timed iterations, replayed as a
    CUDA graph (the sample and the step with its NCCL calls): one K3
    launch per iteration and no K1 launch; the same with ref_order='slot'
    at 100K; then knn_comm='all_gather' at 1M, whose local top-k is K1;
    with --profile also 'ring_pallas' at 1M on a one-rank mesh without a
    process group (no NCCL call), which prices the collectives. Then
    phase 20 on this group;
12. sharded against single-card: 5 injected-sample steps of the one-rank
    'ring_pallas' step and of GraphEmbedderTorch(knn_strategy='binfold'),
    both on the card, allclose, with the engines' own sums;
13. several cards, only where torch.cuda.device_count() >= 2: the cards'
    peer access and `nvidia-smi topo -m`, then min(count, 4) NCCL ranks,
    one process each; every rank's ring neighbours must be reachable
    (check_ring_peers); the 'ring_pallas' neighbour sets through the
    sharded step (_debug_knn) equal ring_binfold_topk_virtual's on the
    same positions and sample, positions are bit-equal on every rank after
    5 steps with one K3 launch per step on each rank (the carries travel
    inside it), and after 3 run_layout iterations every rank draws the same
    next sample and each rank's own update stayed within REPLICA_GAP_LIMIT
    of rank 0's before the broadcast; an engine whose ranks start apart
    raises at the end of its replayed run_layout on every rank but rank 0;
    phase 20 for every knn_comm and both ref orders on the ranks; each
    rank's row-sharded Chebyshev start (one all_gather per matvec) equals
    rank 0's and its own single-card runner's modulo column signs at
    atol=1e-4; with --profile each rank then times 20 replayed iterations
    of the 1M graph with 'ring_pallas' and with 'all_gather', traces 10 of
    each, and times K3's whole ring on its four-card tile against as many
    per-hop launches. On one card the phase prints {"phase":
    "multi_card", "skipped": "1 card"} and runs nothing;
14. spectral init, run after phase 10: the Chebyshev tier on the card
    (twice: cold, then warm with its peak memory) against the same on the
    CPU (alignment >= 0.999, the smallest canonical correlation of the
    spans) and host eigsh, on three 100K graphs, each line with the SpMV's
    overflow form: ring + 300K chords (the 1M
    graph's construction at 100K), whose lowest eigenvalues are apart,
    where the card must align with eigsh at >= 0.95; the same with three
    hubs of 20,000, 10,000 and 5,000 edges, which must take the hub
    block-fold plan (its blocks summed by the accumulator), align
    with eigsh at >= 0.95, and whose card columns must equal the CPU's
    modulo sign at atol=1e-4; and the main path's
    8-regular graph, whose 8 lowest nontrivial eigenvalues lie within
    1.2e-3 of each other, where the alignment is printed and the card's span must
    lie in eigsh's 8 lowest nontrivial eigenvectors at >= 0.95. LOBPCG on
    the card on the first graph: finite, its alignment printed;
15. toolkit, run after phase 12: run_benchmark(generate_ba, n=20,000,
    m=3, compute_centrality=False) on the card (K1, one launch per
    iteration, at the shape phase 3 checked), Spearman(radius, degree) >=
    0.5; the vendored karate
    graph (load_dataset_as_adjacency, a temporary data directory) through
    create_graphem and run_layout(30), Spearman > 0.4;
16. graph against eager, run after phase 9: on phase 9's graph with
    knn_strategy='binfold' and on the 100K graph (K1), after one iteration
    each, 5 iterations by graph replay against 5 of the eager loop from the
    same generator state and start, with the engines' own sums (no global
    switch): the samples of every iteration and the positions must be
    bit-equal;
17. approx: the 100K and the 1M graph with n_neighbors=48 (k+1 = 49 >
    K1's MAX_K) and init='random' must resolve 'approx'; each prints the
    fused-refs choice, whether the one-shot pass fits its budget,
    run_layout(50) ms/iter, the peak memory from the warm-up on (a replay
    allocates nothing) and the memory reserved, launches no K1 or K2, and
    on one iteration's queries recalls all of knn_exact's neighbours (by
    distance: within the exact k-th distance) and prints the one-shot
    pass's peak over its (S, E) matrix;
18. slot: the 100K main path with ref_order='slot' (init='random'),
    run_layout(50) as phase 5, one K1 launch per iteration, at shapes
    phase 3 checked;
19. ring transfer, run after phase 10: K3's whole-ring launch through its
    store-and-flag transfer on one card, over 2, 4 and 8 virtual ranks
    whose regions stand in for the neighbours' cards (512 queries against
    the 1M graph's refs split into tiles): one hop per launch per rank in
    ring order, and every rank's whole ring at once on its own stream with
    1/ndev of the resident blocks; the same over 3, 4 and 8 ranks of 70,000
    refs with 200 queries, where most runs are pieces; three ring calls
    each on the same regions; distances and ids bit-equal to the per-hop
    ring every call;
20. sharded graph against eager: the one-rank NCCL group, every knn_comm
    with both ref orders on phase 9's graph, and 'ring_pallas' and
    'all_gather' on the 100K graph: after one iteration each, 5 replayed
    iterations against 5 of the eager loop from the same generator state,
    with the engines' own sums: samples and positions bit-equal;
21. host prep, run after phase 10: the engine's host prep of the 100K
    graph (flat table) and of the 1M graph (binned tables, 35,188
    overflow pairs): the edge extraction and the table build with the
    threaded C helpers of native/ and with their plain numpy versions, in
    turns (plain, C, C, plain), each timed; every output array must be
    equal in value and dtype between the two, the C runs must have called
    each helper of their table kind and the plain runs none. The "host"
    line gives the host CPU model, os.cpu_count(), the CPUs the process
    may use and the helpers' thread count;
22. IC cascade kernel against its plain version, run after phase 21:
    csrc/ic_cascade.cu (one cooperative launch per cascade) and
    ic_cascade_reference on the same packed seed words and Philox key, at
    the 100K plan (cap 8, no overflow), the 1M plan (cap 13, 35,188
    overflow in-edges, no chunk) and the heavy-tail 1M plan (ring + 3M
    zipf chords, cap 7, about 2.28M overflow in-edges in some 3,100
    chunks of the dense pass, the 16 largest hubs vertices 0-15) with 10
    random seeds in 64 columns at p=0.1, and at
    the hub graph's first greedy chunk (64 candidates x 32 runs, B=2048,
    W=64, run r of every candidate on the same coins, as greedy runs it)
    at p=0.2; each also at p=0 and p=1, and each in every step mode of
    the kernel (push, dense and auto). Active words, counts and steps must
    be bit-equal in every mode, one launch per cascade, the dense steps
    those the plain version's pairs per step give (none forced push, all
    forced dense), p=0 exactly the seeds and p=1 exactly the seeds'
    components in every column. At each shape's own p: the steps, the
    pairs behind the frontier per step, the coins drawn, the kernel's time
    per call (auto) and back to back (each mode), the plain version's,
    the push lists' build time and bytes, the bound (each input read and
    each output written once as far as the run needs it: the seed words,
    the push lists of the vertices ever in the frontier, the active words;
    against the coins' Philox instructions),
    the frontier-driven traffic model (frontier_model_ms) and the
    per-step model of a dense step every step (step_bytes_ms);
23. the scatter-form IC, run after phase 22, on ring + 36M chords at
    12,000,000 vertices (bench.py's scale family; its cascade table, cap
    13, would pass the 2^27-slot budget), built once and freed after the
    phase: csrc/ic_scatter.cu (one cooperative launch per cascade) against
    ic_scatter_reference on the same packed seed words and key, on the
    directed edge lists of the 1M graph and the 12M graph (10 random seeds
    in 64 columns, p=0.1) and of phase 22's hub greedy chunk (B=2048,
    W=64, p=0.2), each also at p=0 and p=1 and in every step mode (push,
    dense, auto): active words, counts and steps bit-equal, one launch per
    cascade, the dense steps as in phase 22, p=0 exactly the seeds and p=1
    exactly their components (all 12M vertices in every column); at each
    shape's p the steps, the pairs per step, the coins drawn, the kernel's
    time per call (auto) and back to back (each mode), the plain
    version's (its compared run), the push lists' build time and bytes,
    the bound (as in phase 22), the frontier-driven traffic
    model and the per-step model of a dense step every step. Then the
    main path: grt.estimated_influence on the 12M graph at p=0.1 over 64
    runs (its wall seconds, split into the edge extraction, the plan
    decision, the directed lists' build and upload, and the device part:
    their push lists, the cascade and the wait for the counts; and its
    peak memory), at p=0 and at p=1
    (exact): three ic_scatter launches and no ic_cascade launch. The phase adds about 45 s
    to the run on an H100: the graph's build about 9 s, the plain version
    at 12M about 17 s over its three calls (p=0.1 about 10 s, timed once
    in the compared run), each 12M estimate about 6 s of host work;
24. determinism, run after phases 5 and 6: beside each main-path run a
    second engine of the same seed and options (the 100K flat graph with
    init='auto', host eigsh; the 1M binned + overflow-plan graph with
    init='auto', the card's Chebyshev): its start and its positions after
    the run's iterations must be bit-equal to the first engine's; its
    checkpoint after 25 replayed iterations, loaded into a third engine
    and run 25 more, must equal its own positions after 50; phase 9's
    'pallas' case runs again, and its card positions and max_abs_err must
    equal the first run's. No check switches PyTorch's global determinism
    on;
25. the accumulator (csrc/segment_sum.cu: the cluster kernel, the tile
    sort and the sum) against its plain versions, after every other phase:
    the sums that one eager step of each layout path that launches it asks
    for, recorded from its engine (the second engine of each main-path
    graph in phase 24, the quick start's and 'approx''s engines on both
    graphs, the sharded engines of phase 11, the karate engine of phase 15
    and phase 26's engine), and phase 26's unplanned spring_forces: the
    intersection repulsion's 4*S*k terms of d=3 (30,720 into 100K and 1M
    rows, 'approx''s 98,304: the cluster form; 184,320 at sample_size=3072
    and the spring's 799,968: the tiled form), the 1M block plan's hub
    blocks (the static form), and the static form's long runs: built in
    numpy from the scale tiers' heavy-tail graph (skewed_1m: ring + 3M
    zipf(1.6) chords), its layout step's hub block plan (84,827 blocks of
    32 onto 14,996 hubs, the widest 22,841; d=3) and its Chebyshev SpMV's
    (s=8), random values from a seed. Each is run twice through segment_sum (or
    segment_sum_sorted) and once by index_add_ on the CPU, bit-equal, with
    one cluster launch a cluster-form call and one tile sort and one sum a
    tiled one; a cluster-form call also equals its plain version (a stable
    torch.sort of the whole id list, then the ascending loop, on the CPU),
    and at every dynamic call the tile sort's keys, places and masks equal
    its plain version's (a stable torch.sort of each tile on the CPU). The
    times: the form's per call, back to back and replayed in a CUDA graph
    as the layout step runs it; at every dynamic call the tiled form's
    (the tile sort and the sum, apart and together, replayed: the form
    every dynamic call took before the cluster kernel); the plain versions
    on the CPU; index_add_ on the card, with its float atomics and under
    torch.use_deterministic_algorithms(True) (a sorted index_put_; the
    setting restored after the call), per call and replayed, each held
    against the CPU's bits; the plain-torch form (a stable torch.sort,
    searchsorted offsets, torch.segment_reduce), and the bounds (each id,
    value and touched row read once and each touched row written once; the
    sort's ids read, keys, places and touched mask words written, against
    its compare-exchanges; a static call's order floor, its longest run of
    dependent adds at 4 cycles and the card's top SM clock). The summary's
    static entry is the heavy-tail step plan's call;
26. the tiled form on a layout path, before phase 25: the 100K graph at
    sample_size=3072, whose 4*S*k = 184,320 terms pass the cluster's
    capacity, 20 iterations under replay: one tile sort and one tiled sum
    an iteration, no cluster launch; one step's calls and the graph's
    unplanned spring_forces recorded for phase 25;
27. scale_main, run after phase 23 on its 12M graph (before the graph is
    freed): GraphEmbedderTorch with the JAX scale scripts' settings and
    init='random', whose ~70M fused refs pass K1's 2^24-ref bound: the
    strategy must be fused binfold over n_seg >= 2 segments. On one
    step's queries and fused refs, the segmented K1 (n_seg launches, the
    segment ids lifted, one torch.topk merge) against the plain
    per-segment fold and the same merge: each segment's bins and the
    merged pairs bit-equal; its time per call and back to back, the folds
    alone back to back, beside its bound. Then two replayed iterations
    against the eager step from the same start on each replay's sample,
    bit-equal, and 20 replayed iterations with the counts zeroed just
    before: n_seg K1 launches and one cluster launch an iteration, finite
    positions of std ~1; ms/iter, device ms/iter, peak memory and the
    phase's seconds.

Each main-path (5, 6, 18, 27), quick-start, greedy, scatter-path (23),
sharded and toolkit phase zeroes the kernels' launch counts just before
its timed run and reads them just after; each layout path also fails
unless the accumulator's cluster kernel ran exactly once an iteration (the
intersection repulsion's ids) and its tile sort not at all (phase 26: one
tile sort an iteration and no cluster launch), and the main paths unless
its sum ran exactly once an iteration for each static plan (a hub block
plan, the COO overflow tails). A handler
on the spectral init's logger records every tier-down warning, and a
phase whose engines logged one fails. The line before the last is the
kernel summary {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}. Any failure raises and exits nonzero.
"""

import contextlib
import importlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FORCE_PARAMS = dict(L_min=10.0, k_attr=0.5, k_inter=0.1, n_neighbors=15,
                    sample_size=512)
ITERS = 50
# phase 14's hub graph: the card's Chebyshev columns against the CPU's,
# modulo sign (JAX's atol for its sharded runner against the single one)
SPECTRAL_BLOCK_ATOL = 1e-4
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the Philox key of phases 22 and 23's kernel-against-plain comparisons
IC_KEY = (0x2545F491, 0x6C078965)
# a Philox4x32-10 draw is about 78 integer instructions and serves up to
# 4 coins
PHILOX_INSTR = 78
# the IC kernels' step modes, each held against the plain version
IC_MODES = ("push", "dense", "auto")
# phase 8's timed greedy: a union of four random Hamiltonian cycles
GREEDY_LARGE_N = 20_000
# phase 23's graph: the smallest of bench.py's scale family (ring + 3n
# chords) whose cascade table passes the 2^27-slot budget (cap 13)
SCATTER_N = 12_000_000
# The H100 SXM's device memory rate (bytes/s), for the accumulator's bound
MEM_BYTES_PER_S = 3.35e12
# cycles of one dependent fp32 add: the static sum's order floor is a row's
# longest run of them at the card's top SM clock
FADD_CYCLES = 4
# phase 25's heavy-tail graph (experiments/bench_1m_skewed.py, the scale
# tiers' skewed_1m): ring + 3M chords, the first endpoint a zipf(1.6) rank
SKEWED_N, SKEWED_CHORDS, SKEWED_ZIPF_A = 1_000_000, 3_000_000, 1.6
# the host's CUDA calls that put work on a stream, counted by --profile
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
               "cudaGraphLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")


class SpectralLog(logging.Handler):
    """The spectral init's log records: the Chebyshev tier's seconds and
    Ritz values (INFO) and any tier-down (WARNING)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def take(self, label):
        """The records since the last take; raises on a tier-down."""
        out, self.records = self.records, []
        down = [r.getMessage() for r in out if r.levelno >= logging.WARNING]
        if down:
            raise AssertionError(f"{label}: the spectral init tiered down: "
                                 f"{down}")
        return out


def spectral_log():
    """A SpectralLog attached to the port's laplacian logger."""
    log = SpectralLog()
    lg = logging.getLogger("graphem_rapids_torch.ops.laplacian")
    lg.addHandler(log)
    lg.setLevel(logging.INFO)
    return log


def alignment(X, Y):
    """Smallest canonical correlation between the column spans."""
    Qx, _ = np.linalg.qr(np.asarray(X, np.float64))
    Qy, _ = np.linalg.qr(np.asarray(Y, np.float64))
    return float(np.linalg.svd(Qx.T @ Qy, compute_uv=False).min())


def max_err_modulo_signs(X, Y):
    """Largest |X - Y| over columns, each column's sign chosen best."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    return float(max(min(np.abs(X[:, c] - Y[:, c]).max(),
                         np.abs(X[:, c] + Y[:, c]).max())
                     for c in range(Y.shape[1])))


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of ``fn()`` in ms over ``reps`` calls."""
    from graphem_rapids_torch.utils.profiling import time_fn

    return time_fn(fn, reps=reps, warmup=warmup) * 1e3


def cpu_ms(fn, reps=20, warmup=3):
    """Median host time of ``fn()`` in ms over ``reps`` calls, for CPU
    tensors."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def nvidia_smi_topology():
    """``nvidia-smi topo -m``, line by line."""
    out = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True, check=False).stdout
    return [ln.rstrip() for ln in out.splitlines() if ln.strip()]


def regular_union_graph(n, cycles=4, seed=0):
    """Union of ``cycles`` random Hamiltonian cycles (near-regular, degree
    2*cycles), repeated edges dropped; numpy + scipy only."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    e = []
    for _ in range(cycles):
        p = rng.permutation(n)
        e.append(np.column_stack([p, np.roll(p, -1)]))
    e = np.concatenate(e)
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def ring_chords_graph(n=1_000_000, chords=3_000_000, seed=0):
    """Ring + random chords, built exactly as bench.py build_scale_graph."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    ch = rng.integers(0, n, (chords, 2))
    ch = ch[ch[:, 0] != ch[:, 1]]
    e = np.concatenate([ring, ch])
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def skewed_graph(n=SKEWED_N, chords=SKEWED_CHORDS, seed=0):
    """Ring + ``chords`` chords whose first endpoint is a zipf(1.6) rank
    (low ids become hubs of up to 731K edges): the heavy-tail graph of
    experiments/bench_1m_skewed.py, built as scripts/torch_scale_tiers.py
    builds its skewed_1m tier."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    za = np.minimum(rng.zipf(SKEWED_ZIPF_A, chords), n) - 1
    zb = rng.integers(0, n, chords)
    ch = np.column_stack([za, zb])
    ch = ch[ch[:, 0] != ch[:, 1]]
    e = np.concatenate([ring, ch])
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def binned_tables(adj):
    """The binned neighbour tables of ``adj`` as the engine builds them for
    the layout step (as constructed with the defaults)."""
    from graphem_rapids_torch.models.embedder import csr_upper_edges
    from graphem_rapids_torch.ops import knn_binfold as bf
    from graphem_rapids_torch.ops.forces import build_neighbor_table_binned

    return build_neighbor_table_binned(
        csr_upper_edges(adj), adj.shape[0], overhead_rows=4096,
        ref_order="row", ref_budget=bf.MAX_REFS_SEGMENTED - 1)


def hub_plan(adj, spmv=False):
    """The hub block plan of ``adj`` as the engine builds it for the
    layout step (``binned_tables``), or, with ``spmv``, as its spectral
    init builds it for the Chebyshev SpMV."""
    import scipy.sparse as sp

    from graphem_rapids_torch.ops import laplacian as lap

    if spmv:
        A = sp.csr_matrix(adj + adj.transpose())
        A.data = np.ones_like(A.data)
        A.setdiag(0)
        A.eliminate_zeros()
        return lap._adjacency_matvec_plan(A)["ov_plan"]
    return binned_tables(adj)["overflow_plan"]


def skewed_static_calls():
    """Phase 25's two static calls of the heavy-tail graph, with random
    values from a seed and rows from zero, as their callers start them:
    the layout step's hub block plan (``apply_overflow_plan``: its
    block_hub as the engine builds and uploads it, d=3) and the Chebyshev
    SpMV's (``_overflow_correct``, s=8 columns). Entries as RECORDED_SUMS
    holds them."""
    adj = skewed_graph()
    gen = torch.Generator().manual_seed(5)
    calls = []
    for label, spmv, d in (("skewed_1m hub plan", False, 3),
                           ("skewed_1m chebyshev hub plan", True, 8)):
        plan = hub_plan(adj, spmv)
        keys = torch.as_tensor(np.asarray(plan["block_hub"])).long()
        rows = len(plan["hub_ids"])
        calls.append((label, "static", torch.zeros(rows, d, device="cuda"),
                      keys.cuda(), torch.randn(len(keys), d,
                                               generator=gen).cuda(), None))
    return calls


def hub_chords_graph(n=100_000, chords=300_000, hubs=(20_000, 10_000, 5_000),
                     seed=0):
    """ring_chords_graph plus hubs 0, 1, 2 joined to 20,000, 10,000 and
    5,000 random vertices: rows far past the SpMV table's cap, so the
    Chebyshev tier folds them through the hub block-fold plan."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed + 1)
    e = np.concatenate([
        np.column_stack([np.full(d, h), rng.choice(n, d, replace=False)])
        for h, d in enumerate(hubs)])
    e = e[e[:, 0] != e[:, 1]]
    b = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    a = ring_chords_graph(n, chords, seed) + b + b.T
    a.data[:] = 1
    return a.tocsr()


def replayed_ms(fn, reps=20, warmup=3):
    """The card's ms per call of ``fn()`` as the layout step runs it: one
    CUDA graph of ``reps`` calls, replayed, between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def back_to_back_ms(fn, reps=20, warmup=3):
    """The card's ms per call of ``fn()``: CUDA events around ``reps``
    calls launched back to back, so the host's enqueueing of one call
    overlaps the card's work on the one before (cuda_ms, one call at a
    time, also counts the card waiting for the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(report, name, entry):
    """The -Xptxas -v lines (registers, spills) of the instantiation whose
    mangled name holds ``entry``, from the build phase's report."""
    lines = report.get(name, {}).get("log", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            found = []
            for ln in lines[i + 1:]:
                if "Compiling entry function" in ln:
                    break
                if "registers" in ln or "spill" in ln:
                    found.append(ln.split(":", 1)[-1].strip())
            return found
    return []


def spills(ptxas):
    """True if the ptxas lines report a stack frame or spills."""
    return any("spill" in ln and not ln.startswith(
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill")
        for ln in ptxas)


def phase_kernel(bf, fp32_instr_per_s, build_report, toolkit_shape):
    """Phase 3: K1 against its plain version on the card, at the main
    path's and the toolkit's shapes (``toolkit_shape``: its (S, E, d)) and
    at the plan's edges. Returns the timings and 'checked', the (S, E, d,
    T, G, n_super) of every case."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    checked = set()

    def inputs(S, E, d, pad_rows=0):
        q = torch.randn(S, d, generator=gen)
        r = torch.randn(E, d, generator=gen)
        if pad_rows:
            r[torch.randperm(E, generator=gen)[:pad_rows]] = 1e30
        return q.cuda(), r.cuda()

    def check(name, q, r, k, T=2048, G=24):
        G_eff, n_super = bf._geometry(r.shape[0], T, G)
        kv, ki = bf.binfold_bins_cuda(q, r, T, G_eff, n_super)
        torch.cuda.synchronize()
        # the plain fold is row by row: 64 query rows at a time
        parts = [bf.binfold_bins_reference(q[i:i + 64], r, T, G_eff, n_super)
                 for i in range(0, q.shape[0], 64)]
        pv = torch.cat([v for v, _ in parts])
        pi = torch.cat([i for _, i in parts])
        bins_equal = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
        err = float((kv - pv).abs().max())
        tk_v, tk_p = torch.topk(kv, k, dim=1, largest=False)
        tp_v, tp_p = torch.topk(pv, k, dim=1, largest=False)
        sets_k = torch.sort(torch.gather(ki, 1, tk_p), dim=1).values
        sets_p = torch.sort(torch.gather(pi, 1, tp_p), dim=1).values
        topk_equal = bool(torch.equal(tk_v, tp_v) and torch.equal(sets_k, sets_p))
        qb, _, units, n_blocks = bf.fold_plan(
            q.shape[0], G_eff, n_super, n_sm, q.shape[1],
            bf._blocks_per_sm(q.device, q.shape[1]))
        emit("kernel_check", case=name, S=q.shape[0], E=r.shape[0],
             d=q.shape[1], k=k, T=T, G=G_eff, n_super=n_super, qb=qb,
             units=units, blocks=n_blocks,
             pieces=sum(1 for _, _, s0, s1 in bf.fold_runs(units, n_blocks,
                                                           n_super)
                        if (s0, s1) != (0, n_super)),
             bins_bit_equal=bins_equal, topk_equal=topk_equal,
             max_abs_err=err)
        if not (bins_equal and topk_equal):
            raise AssertionError(f"binfold kernel disagrees with plain: {name}")
        checked.add((q.shape[0], r.shape[0], q.shape[1], T, G_eff, n_super))
        return G_eff, n_super, err

    S, d, k, T = 512, 3, 16, 2048
    q, r = inputs(S, 800_000, d, pad_rows=800_000 // 40)
    _, _, err_main = check("main_100k", q, r, k)
    q1m, r1m = inputs(S, 5_699_741, d, pad_rows=5_699_741 // 40)
    check("main_1m", q1m, r1m, k)  # many units per block
    check("wave_diagnostic_s416", q1m[:416], r1m, k)
    check("ragged_d2_gclamp", *inputs(7, 9001, 2), 4)  # fewer units than blocks
    check("ragged_d4_gclamp", *inputs(7, 20_000 + 77, 4), 5)
    check("n_super_1", *inputs(500, 24 * 2048, d, pad_rows=1000), k)
    S_t, E_t, d_t = toolkit_shape
    check("toolkit_ba_20k", *inputs(S_t, E_t, d_t, pad_rows=E_t // 40), k)
    check("ragged_pieces_d1", *inputs(37, 300_001, 1, pad_rows=77), k)
    check("d8_8_queries_per_block", *inputs(45, 100_000, 8, pad_rows=99), k)
    tile = torch.randn(24 * T, d, generator=gen).cuda()
    periodic = tile.repeat(116, 1)[:5_699_741]  # every piece cut ties
    check("ties_across_pieces_1m_64q", q1m[:64], periodic, k)
    del periodic, tile

    ptx = ptxas_lines(build_report, "binfold", "binfold_kernelILi3E")
    emit("kernel_ptxas", name="knn_binfold", d=d, ptxas=ptx)
    if not ptx or spills(ptx):
        raise AssertionError(f"binfold kernel at d=3: {ptx}")
    out = {"max_abs_err": err_main, "checked": checked}
    # the plain version on all 512 rows: in one call at 100K, as before; at
    # 1M 64 rows a call (an (S, E_pad) block of 11.7 GB otherwise)
    for label, qq, rr, rows in (("100k", q, r, S), ("1m", q1m, r1m, 64)):
        E = rr.shape[0]
        G, n_super = bf._geometry(E, T, 24)
        b2b = {}
        for S_t in (512, 416):  # 624 blocks of 16 queries at 416: one wave
            qs = qq[:S_t]
            b2b[S_t] = back_to_back_ms(
                lambda: bf.binfold_bins_cuda(qs, rr, T, G, n_super))
        ms = cuda_ms(lambda: bf.binfold_bins_cuda(qq, rr, T, G, n_super))
        plain_ms = cuda_ms(
            lambda: [bf.binfold_bins_reference(qq[i:i + rows], rr, T, G,
                                               n_super)
                     for i in range(0, S, rows)],
            reps=20 if rows == S else 3, warmup=1)
        E_pad = n_super * G * T
        # per pair d subtractions, d multiplies, d - 1 adds (0 + x is x),
        # the compare and the two selects of (value, index)
        ops = (3 * d + 2) * S * E_pad
        nbytes = 4 * (S * d + E * d) + 8 * S * G * 128
        ops_ms = ops / fp32_instr_per_s * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        emit("kernel_time", name="knn_binfold", shape=label, S=S, E=E,
             E_pad=E_pad, d=d, kernel_ms=ms, back_to_back_ms=b2b[512],
             plain_ms=plain_ms, plain_rows_per_call=rows, ops=ops,
             bytes=nbytes,
             ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
             share_of_bound=bound / ms,
             share_of_bound_back_to_back=bound / b2b[512],
             back_to_back_ms_s416=b2b[416],
             s416_over_s512=b2b[416] / b2b[512])
        if label == "100k":
            out.update(ms=ms, back_to_back_ms=b2b[512], plain_ms=plain_ms,
                       bound_ms=bound,
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes")
    return out


def phase_kernel_k2(kp, knn_exact, fp32_instr_per_s, build_report):
    """Phase 4: K2 against its plain version on the card."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(S, E, d, pad_keep=None, dup=False):
        q = torch.randn(S, d, generator=gen)
        r = torch.randn(E, d, generator=gen)
        if dup:  # every ref twice, and queries sitting on refs
            r = r[: E // 2].repeat_interleave(2, dim=0)
            q[:8] = r[:8]
        if pad_keep is not None:
            keep = torch.randperm(E, generator=gen)[:pad_keep]
            padded = torch.full_like(r, 1e30)
            padded[keep] = r[keep]
            padded[keep[1]] = padded[keep[0]]
            r = padded
        return q.cuda(), r.cuda()

    def tied_across_slices(S, E, d, k):
        """Each slice's first ref equals the one before it, and queries sit
        on those pairs: ties at distance 0 across every slice boundary."""
        q, r = inputs(S, E, d)
        n, length = kp.slice_plan(S, E, n_sm,
                                  kp._blocks_per_sm(q.device, d, k))
        for i, c in enumerate(range(length, n * length, length)):
            r[c] = r[c - 1]
            if i < S:
                q[i] = r[c]
        return q, r

    worst = 0.0

    def check(name, q, r, k):
        nonlocal worst
        ki, kv = kp.knn_tiled_cuda(q, r, k)
        torch.cuda.synchronize()
        pi, pv = kp.knn_tiled_reference(q, r, k)
        equal = bool(torch.equal(ki, pi) and torch.equal(kv, pv))
        err = float((kv - pv).abs().max())
        worst = max(worst, err)
        n_slices, slice_len = kp.slice_plan(
            q.shape[0], r.shape[0], n_sm,
            kp._blocks_per_sm(q.device, q.shape[1], k))
        emit("kernel_check", kernel="knn_pallas", case=name, S=q.shape[0],
             E=r.shape[0], d=q.shape[1], k=k, slices=n_slices,
             slice_len=slice_len,
             query_blocks=-(-q.shape[0] // kp.QUERIES_PER_BLOCK),
             bit_equal=equal, max_abs_err=err)
        if not equal:
            raise AssertionError(f"tiled kNN kernel disagrees with plain: {name}")

    S, d, k = 512, 3, 16
    q100, r100 = inputs(S, 399_984, d)
    check("midpoints_100k", q100, r100, k)
    q1m, r1m = inputs(S, 3_999_991, d)
    check("midpoints_1m", q1m, r1m, k)
    check("ragged", *inputs(33, 100_003, d), 8)
    check("duplicates_ties", *inputs(64, 200_000, d, dup=True), k)
    check("ties_across_slices", *tied_across_slices(S, 200_000, d, k), k)
    check("pads_fewer_than_k", *inputs(16, 50_000, d, pad_keep=5), k)
    check("k1", *inputs(64, 300_000, d), 1)
    check("k33_S_not_multiple", *inputs(100, 150_000, d), 33)
    check("k128", *inputs(64, 300_000, d), 128)
    check("k128_many_blocks", *inputs(300, 150_000, d), 128)
    check("one_query_many_slices", *inputs(1, 300_000, d), k)
    check("one_slice", *inputs(5000, 2000, d), k)
    check("d1", *inputs(128, 150_000, 1), k)
    check("d2", *inputs(128, 150_000, 2), k)
    check("d4", *inputs(128, 150_000, 4), k)
    check("d8", *inputs(128, 150_000, 8), k)
    check("d11_generic", *inputs(40, 30_000, 11), 9)

    ptx = ptxas_lines(build_report, "knn_tiled", "knn_slices_kernelILi3ELi1E")
    emit("kernel_ptxas", name="knn_pallas", d=d, k=k, ptxas=ptx)
    if not ptx or spills(ptx):
        raise AssertionError(f"tiled kNN kernel at d=3, k=16: {ptx}")
    out = {"max_abs_err": worst}
    for label, q, r, plain_reps in (("100k", q100, r100, 10),
                                    ("1m", q1m, r1m, 3)):
        E = r.shape[0]
        b2b = back_to_back_ms(lambda: kp.knn_tiled_cuda(q, r, k))
        ms = cuda_ms(lambda: kp.knn_tiled_cuda(q, r, k))
        plain_ms = cuda_ms(lambda: kp.knn_tiled_reference(q, r, k),
                           reps=plain_reps, warmup=1)
        # per pair d subtractions, d multiplies, d - 1 adds (0 + x is x)
        # and the compare with the running k-th value
        ops = 3 * d * S * E
        nbytes = 4 * (S * d + E * d) + 8 * S * k
        ops_ms = ops / fp32_instr_per_s * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        try:  # an (S, E) block: 8.2 GB at the 1M shape
            library_ms = cuda_ms(lambda: knn_exact(q, r, k), reps=10)
            library_note = None
        except torch.cuda.OutOfMemoryError as e:
            library_ms, library_note = None, f"out of memory: {e}"[:200]
        torch.cuda.empty_cache()
        emit("kernel_time", name="knn_pallas", shape=label, S=S, E=E, d=d,
             k=k, kernel_ms=ms, back_to_back_ms=b2b, plain_ms=plain_ms,
             ops=ops, bytes=nbytes, ops_bound_ms=ops_ms,
             bytes_bound_ms=bytes_ms, share_of_bound=bound / ms,
             share_of_bound_back_to_back=bound / b2b,
             library="knn_exact (squared_distances + torch.topk)",
             library_ms=library_ms, library_note=library_note)
        if label == "100k":
            out.update(ms=ms, back_to_back_ms=b2b, plain_ms=plain_ms,
                       bound_ms=bound,
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes",
                       library_ms=library_ms)
    return out


def phase_quickstart(grt, bf, kp, label, adj, init, warmup, profile):
    """Phase 7: create_graphem(backend='cuvs') -> run_layout ->
    graphem_seed_selection -> estimated_influence, on the card. Returns
    the K2 launches and the IC cascade kernel's."""
    from scipy.sparse.csgraph import connected_components

    from graphem_rapids_torch.ops import ic_cascade as icc

    t0 = time.perf_counter()
    emb = grt.create_graphem(adj, n_components=3, backend="cuvs", seed=0,
                             verbose=False, init=init, **FORCE_PARAMS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit("quickstart_setup", graph=label, n=emb.n, E=emb.n_edges,
         strategy=emb._strategy, fused_refs=emb._fused_refs_active,
         table=emb.table_kind, batch_size=emb.batch_size, init=init,
         init_s=init_s)
    if emb._strategy != "pallas" or emb.device.type != "cuda":
        raise AssertionError(f"{label}: backend='cuvs' must run 'pallas' on "
                             f"the card, got {emb._strategy} on {emb.device}")
    emb.run_layout(warmup, block_size=warmup)

    kp.knn_pallas.launches = 0
    bf.knn_binfold.launches = 0
    torch.cuda.reset_peak_memory_stats()
    iters = ITERS + 20
    with segment_launches(f"{label} quick start", iters) as seg_count:
        t0 = time.perf_counter()
        pos = emb.run_layout(ITERS, block_size=10)
        dt = time.perf_counter() - t0
        seeds = grt.graphem_seed_selection(emb, k=10)
    launches = kp.knn_pallas.launches
    emit("quickstart_run", graph=label, iters=ITERS, seconds=dt,
         ms_per_iter=dt / ITERS * 1e3, edges_per_s=emb.n_edges * ITERS / dt,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         knn_pallas_launches=launches, binfold_launches=bf.knn_binfold.launches,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         iterations_run=iters,
         seeds=seeds)
    if launches != iters or bf.knn_binfold.launches != 0:
        raise AssertionError(f"{label}: {launches} K2 launches in {iters} "
                             "iterations")
    if pos.shape != (emb.n, 3) or not np.isfinite(emb.positions).all():
        raise AssertionError(f"{label}: positions not finite")
    if len(set(seeds)) != 10:
        raise AssertionError(f"{label}: seeds {seeds}")
    record_step(emb, f"{label} quick start")

    torch.cuda.synchronize()
    icc.ic_cascade.launches = 0
    with program_split(IC_SPANS) as split:
        t0 = time.perf_counter()
        spread = grt.estimated_influence(adj, seeds, p=0.1, num_sims=64)
        ic_s = time.perf_counter() - t0
    split["other_s"] = ic_s - sum(split.values())
    rand = np.random.default_rng(0).choice(emb.n, 10, replace=False).tolist()
    spread_rand = grt.estimated_influence(adj, rand, p=0.1, num_sims=64)
    p0 = grt.estimated_influence(adj, seeds, p=0.0, num_sims=8)
    p1 = grt.estimated_influence(adj, seeds, p=1.0, num_sims=4)
    ic_launches = icc.ic_cascade.launches
    _, comp = connected_components(adj, directed=False)
    exact_p1 = int(np.isin(comp, comp[seeds]).sum())
    emit("quickstart_influence", graph=label, p=0.1, num_sims=64,
         ic_seconds=ic_s, split=split, spread_graphem=spread,
         spread_random=spread_rand, p0_spread=p0, p1_spread=p1,
         p1_exact=exact_p1, cascades=4, ic_cascade_launches=ic_launches)
    if p0 != 10.0 or p1 != exact_p1:
        raise AssertionError(f"{label}: IC gates p=0 -> {p0} (want 10), "
                             f"p=1 -> {p1} (want {exact_p1})")
    if ic_launches != 4:
        raise AssertionError(f"{label}: {ic_launches} ic_cascade launches "
                             "for 4 cascades")
    if profile:
        profile_steps(emb, label + "_pallas", dt / ITERS * 1e3)
        profile_call(
            "profile_ic", label,
            lambda: grt.estimated_influence(adj, rand, p=0.1, num_sims=64),
            lambda: grt.estimated_influence(adj, seeds, p=0.1, num_sims=64),
            ic_s * 1e3, 1)
    return launches, ic_launches


def hub_graph(seed=3):
    """Four stars of 80, 50, 30 and 15 leaves plus 30 random leaf-leaf
    edges: at p=0.2 the hubs' greedy gains are far apart."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    e, nxt = [], 4
    for hub, leaves in enumerate((80, 50, 30, 15)):
        e += [(hub, nxt + j) for j in range(leaves)]
        nxt += leaves
    e += [tuple(sorted(p)) for p in rng.integers(4, nxt, (30, 2))
          if p[0] != p[1]]
    e = np.array(sorted(set(e)))
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(nxt, nxt)).tocsr()
    a.data[:] = 1
    return a + a.T


def two_stars_graph():
    """Vertex 0 with leaves 1..200 and vertex 201 with leaves 202..251: at
    p=1 greedy's second seed is 201 (a leaf of the first star gains
    nothing)."""
    import scipy.sparse as sp

    e = np.array([(0, j) for j in range(1, 201)]
                 + [(201, j) for j in range(202, 252)])
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(252, 252)).tocsr()
    return a + a.T


def phase_greedy(grt):
    """Phase 8: greedy seeds on the card equal those on the CPU (hub
    graph), on the gather path and on the scatter path's full sweep (the
    table budget patched to 0: one ic_scatter launch per chunk, no
    ic_cascade launch); on the two-star graph at p=1 the card and the CPU
    both take [0, 201] (greedy's CELF caches marginal gains); on a
    2,000-vertex graph greedy through the cascade kernel gives exactly
    the seeds of greedy through its plain version on the card (the same
    coins); greedy on a 20,000-vertex graph (k=3, p=0.1, 32 runs), timed,
    on one build of the plan's push lists. The scatter-path greedy, too,
    builds its lists once. Returns the launches of ic_cascade and of
    ic_scatter in the greedy runs through them."""
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_scatter as ics
    from graphem_rapids_torch.ops import ic_sim as tic

    adj = hub_graph()
    kw = dict(p=0.2, iterations_count=50, num_sims=32, seed=0)
    icc.ic_cascade.launches = 0
    t0 = time.perf_counter()
    card, evals = grt.greedy_seed_selection(adj, 3, **kw)
    dt = time.perf_counter() - t0
    launches = icc.ic_cascade.launches
    cpu, _ = grt.greedy_seed_selection(adj, 3, device="cpu", **kw)
    emit("greedy", graph="hub", n=adj.shape[0], seeds_card=card,
         seeds_cpu=cpu, evaluations=evals, seconds_card=dt,
         ic_cascade_launches=launches)
    if card != cpu:
        raise AssertionError(f"greedy seeds differ: card {card}, cpu {cpu}")

    budget = tic.TABLE_BUDGET_SLOTS
    tic.TABLE_BUDGET_SLOTS = 0
    try:
        icc.ic_cascade.launches = 0
        ics.ic_scatter.launches = 0
        builds = push_list_builds()
        t0 = time.perf_counter()
        card, evals = grt.greedy_seed_selection(adj, 3, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        scatter_launches = ics.ic_scatter.launches
        gather = icc.ic_cascade.launches
        builds = push_list_builds() - builds
        cpu, cpu_evals = grt.greedy_seed_selection(adj, 3, device="cpu",
                                                   **kw)
    finally:
        tic.TABLE_BUDGET_SLOTS = budget
    emit("greedy", graph="hub_scatter_path", n=adj.shape[0],
         seeds_card=card, seeds_cpu=cpu, evaluations=evals, seconds_card=dt,
         ic_scatter_launches=scatter_launches, ic_cascade_launches=gather,
         push_list_builds=builds)
    if (card, evals) != (cpu, cpu_evals) or gather != 0 or \
            scatter_launches != 3 or builds != 1:
        raise AssertionError(f"scatter-path greedy: card {card} ({evals}), "
                             f"cpu {cpu} ({cpu_evals}), {scatter_launches} "
                             f"ic_scatter and {gather} ic_cascade launches "
                             f"(one chunk a round), {builds} push-list "
                             "builds (one)")

    adj = two_stars_graph()
    kw2 = dict(p=1.0, iterations_count=200, num_sims=4, seed=0)
    icc.ic_cascade.launches = 0
    card, evals = grt.greedy_seed_selection(adj, 2, **kw2)
    launches += icc.ic_cascade.launches
    cpu, cpu_evals = grt.greedy_seed_selection(adj, 2, device="cpu", **kw2)
    emit("greedy", graph="two_stars", n=adj.shape[0], p=1.0,
         seeds_card=card, seeds_cpu=cpu, evaluations=evals,
         evaluations_cpu=cpu_evals,
         ic_cascade_launches=icc.ic_cascade.launches)
    if card != [0, 201] or cpu != [0, 201]:
        raise AssertionError(f"two-star greedy: card {card}, cpu {cpu}; the "
                             "full sweep takes [0, 201]")

    adj = regular_union_graph(2000)
    kw = dict(p=0.1, iterations_count=200, num_sims=32, seed=0)
    icc.ic_cascade.launches = 0
    t0 = time.perf_counter()
    kern, evals = grt.greedy_seed_selection(adj, 5, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kern_launches = icc.ic_cascade.launches
    with plain_cascade():
        t0 = time.perf_counter()
        plain, plain_evals = grt.greedy_seed_selection(adj, 5, **kw)
        torch.cuda.synchronize()
        dt_plain = time.perf_counter() - t0
    emit("greedy", graph="regular_union_2000", n=adj.shape[0],
         seeds_kernel=kern, seeds_plain=plain, evaluations=evals,
         seconds_kernel=dt, seconds_plain=dt_plain,
         ic_cascade_launches=kern_launches,
         plain_launches=icc.ic_cascade.launches - kern_launches)
    if (kern, evals) != (plain, plain_evals) or \
            icc.ic_cascade.launches != kern_launches:
        raise AssertionError(f"greedy through the kernel {kern} ({evals}) "
                             f"and its plain version {plain} "
                             f"({plain_evals})")

    adj = regular_union_graph(GREEDY_LARGE_N)
    n = adj.shape[0]
    icc.ic_cascade.launches = 0
    builds = push_list_builds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeds, evals = grt.greedy_seed_selection(adj, 3, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    large = icc.ic_cascade.launches
    builds = push_list_builds() - builds
    emit("greedy", graph=f"regular_union_{n}", n=n, k=3, p=0.1, num_sims=32,
         seeds=seeds, evaluations=evals, seconds_card=dt,
         ic_cascade_launches=large, push_list_builds=builds)
    # the first round alone is ceil(n / 64) chunks of 64 candidates
    if builds != 1 or large < -(-n // 64) or len(set(seeds)) != 3:
        raise AssertionError(f"greedy on {n} vertices: seeds {seeds}, "
                             f"{large} ic_cascade launches, {builds} "
                             "push-list builds (one per plan)")
    return launches + kern_launches + large, scatter_launches


def push_list_builds():
    """The push lists built so far: the gather plans' and the edge
    lists'."""
    from graphem_rapids_torch.ops import ic_cascade as icc

    return icc.push_lists.builds


def profile_steps(emb, label, untraced_ms_per_iter, iters=10):
    """torch.profiler over ``iters`` steps: device time per iteration by
    kernel, and its share of the untraced wall time per iteration."""
    return profile_call("profile", label,
                        lambda: emb.run_layout(1, block_size=1),
                        lambda: emb.run_layout(iters, block_size=iters),
                        untraced_ms_per_iter, iters)


def profile_call(phase, label, warm, fn, untraced_ms, per):
    """torch.profiler over ``fn()``: device ms by kernel divided by ``per``,
    and the busy share against ``untraced_ms`` (wall ms per ``per``);
    prints the row and returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # first use initializes CUPTI
        warm()
    with profile(activities=activities) as prof:
        fn()
    rows = [
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / per
    host = {ev.key: ev.count / per for ev in prof.key_averages()
            if ev.key in LAUNCH_APIS}
    row = dict(graph=label, per=per,
               device_ms_per_iter=busy_ms,
               untraced_ms_per_iter=untraced_ms,
               device_busy_share=busy_ms / untraced_ms,
               kernels_per_iter=sum(r[2] for r in rows) / per,
               host_launches_per_iter=sum(host.values()),
               host_launch_calls=host,
               top=[{"kernel": key[:90], "ms_per_iter": us / 1e3 / per,
                     "calls_per_iter": c / per}
                    for us, key, c in rows[:12]])
    emit(phase, **row)
    return row


@contextlib.contextmanager
def k1_shapes(bf, checked, label):
    """Records the (S, E, d, T, G, n_super) of every K1 launch inside; on
    leaving, fails if one of them is not a shape phase 3 ``checked``."""
    shapes, launch = set(), bf.binfold_bins_cuda

    def recorded(q, r, T, G, n_super):
        shapes.add((q.shape[0], r.shape[0], q.shape[1], T, G, n_super))
        return launch(q, r, T, G, n_super)

    bf.binfold_bins_cuda = recorded
    try:
        yield shapes
    finally:
        bf.binfold_bins_cuda = launch
    if not shapes:
        raise AssertionError(f"{label}: K1 never launched")
    if not shapes <= checked:
        raise AssertionError(f"{label}: K1 ran at {sorted(shapes - checked)}"
                             ", which phase 3 did not check")


TOOLKIT_PARAMS = {"n": 20_000, "m": 3, "seed": 0}


def toolkit_k1_shape(grt):
    """The (S, E, d) of the toolkit phase's K1 launches: its graph in an
    engine built with run_benchmark's defaults (the init does not change
    the refs)."""
    emb = grt.GraphEmbedderTorch(
        grt.generate_ba(**TOOLKIT_PARAMS), n_components=3, seed=0,
        verbose=False, init="random", knn_strategy="auto", **FORCE_PARAMS)
    if emb._strategy != "binfold":
        raise AssertionError(f"toolkit: strategy {emb._strategy}, expected "
                             "binfold")
    refs = (len(emb._nb["ref_edge"]) if emb._fused_refs_active
            else emb.n_edges)
    return emb.sample_size, int(refs), 3


def assert_same(a, b, path):
    """Equal in value, shape and dtype, through dicts, lists and tuples."""
    if a is None or b is None:
        if not (a is None and b is None):
            raise AssertionError(f"{path}: one side is None")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        for key in a:
            assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a,
                                                                          b):
            raise AssertionError(f"{path}: {a.dtype}{a.shape} differs from "
                                 f"{b.dtype}{b.shape}")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")


def cpu_model():
    """The host CPU's model name, vendor, family and model number, from the
    first processor of /proc/cpuinfo (a virtual machine may report the name
    as 'unknown')."""
    fields = {}
    with open("/proc/cpuinfo", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    return (f"{fields.get('model name')} ({fields.get('vendor_id')} family "
            f"{fields.get('cpu family')} model {fields.get('model')})")


def host_prep(adj, native):
    """The engine's host prep: the edge extraction, then the table build
    as GraphEmbedderTorch runs it on a card (binned, else flat, under K1's
    ref budget), with the C helpers or (``native=False``) their plain
    versions. Returns (edges, tables, seconds of each)."""
    from graphem_rapids_torch.models.embedder import csr_upper_edges
    from graphem_rapids_torch.ops import forces
    from graphem_rapids_torch.ops import knn_binfold as bf

    n, budget = adj.shape[0], bf.MAX_REFS_SEGMENTED - 1
    t0 = time.perf_counter()
    edges = csr_upper_edges(adj, native=native)
    t1 = time.perf_counter()
    nb = forces.build_neighbor_table_binned(edges, n, ref_budget=budget,
                                            native=native)
    if nb is None:
        nb = forces.build_neighbor_table(edges, n, ref_budget=budget,
                                         native=native)
    return edges, nb, {"extract_s": t1 - t0,
                       "tables_s": time.perf_counter() - t1}


# the C helpers each table kind's build goes through (with the extraction)
HOST_HELPERS = {
    "flat": ("csr_lt_edges_native", "radix_argsort_native",
             "scatter_ranks_native"),
    "binned": ("csr_lt_edges_native", "radix_argsort_native",
               "scatter_ranks_native", "apply_perm_minmax_native",
               "permute_pairs_native"),
}


def helper_calls(fg):
    return {fn.__name__: fn.calls for fn in fg.NATIVE}


def phase_host_prep(graphs):
    """Phase 21: the host prep of both graphs with the C helpers and with
    their plain versions, in turns (plain, C, C, plain): every output array
    equal in value and dtype, the helpers of the table kind called on the
    C runs and none on the plain ones."""
    from graphem_rapids_torch import native as fg

    threads = fg._nthreads(None)
    emit("host", cpu_model=cpu_model(), cpu_count=os.cpu_count(),
         affinity=len(os.sched_getaffinity(0)), threads=threads,
         library=str(fg.library()._name))
    for label, adj, expect_table in graphs:
        secs = {True: [], False: []}
        outs = {}
        for native in (False, True, True, False):
            for fn in fg.NATIVE:
                fn.calls = 0
            edges, nb, t = host_prep(adj, native)
            calls = helper_calls(fg)
            secs[native].append(t)
            outs[native] = (edges, nb)
            kind = "binned" if "buckets" in nb else "flat"
            if native:
                missing = [h for h in HOST_HELPERS[kind] if not calls[h]]
                if missing:
                    raise AssertionError(f"{label}: the C helpers {missing} "
                                         "did not run")
                native_calls = calls
            elif any(calls.values()):
                raise AssertionError(f"{label}: the plain path called the C "
                                     f"helpers: {calls}")
        assert_same(outs[True], outs[False], label)
        emit("host_prep", graph=label, n=adj.shape[0], E=len(edges),
             table=kind, overflow_pairs=int(len(nb["overflow"])),
             threads=threads, calls=native_calls,
             native_extract_s=[t["extract_s"] for t in secs[True]],
             plain_extract_s=[t["extract_s"] for t in secs[False]],
             native_tables_s=[t["tables_s"] for t in secs[True]],
             plain_tables_s=[t["tables_s"] for t in secs[False]])
        if kind != expect_table:
            raise AssertionError(f"{label}: table {kind}, expected "
                                 f"{expect_table}")


@contextlib.contextmanager
def program_split(fields):
    """Seconds of the program's own spans (``utils/tracing.py``) recorded
    inside: ``fields`` maps each field to the span names it sums."""
    from graphem_rapids_torch.utils import tracing

    tracing.reset()
    secs = {}
    try:
        yield secs
    finally:
        spans = tracing.snapshot()["spans"]
        secs.update({key: sum(spans[n]["total_ns"] for n in names
                              if n in spans) / 1e9
                     for key, names in fields.items()})


# An IC estimate's stages: the edge extraction, the cascade plan's build
# on the host (past the table budget only the decision), its upload (the
# scatter path: the directed edge lists' build and upload), and on the
# device the push lists' build, the launch and the wait for the counts.
IC_SPANS = {"extract_s": ("ic.extract",), "plan_s": ("ic.plan",),
            "upload_s": ("ic.upload",),
            "device_s": ("ic.push", "ic.cascade", "ic.read")}

# GraphEmbedderTorch's set-up stages: the edge extraction, the tables, the
# spectral init and the step's upload (_build_step).
SETUP_SPANS = {"extract_s": ("setup.edges",), "tables_s": ("setup.tables",),
               "spectral_s": ("setup.spectral",),
               "upload_s": ("setup.upload",)}


@contextlib.contextmanager
def plain_cascade():
    """Inside, the gather IC runs ic_cascade's plain version on the card
    (the comparisons of phases 8 and 22, never the main path)."""
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_sim as tic

    def plain(*args, lists=None, mode="auto", stats=None):
        icc._check(*args, lists, mode)
        return icc.ic_cascade_reference(*args, stats=stats)

    saved = tic.ic_cascade
    tic.ic_cascade = plain
    try:
        yield
    finally:
        tic.ic_cascade = saved


def ic_cases(graphs, device="cuda"):
    """Phases 22 and 23's shapes: (label, adj, (n, B) bool seed mask on
    the card, p, runs). The (label, adj) ``graphs`` with 10 random seeds
    in all 64 columns (every column its own coins), and the hub graph's
    first greedy chunk: candidates 0..63, 32 runs each (column 32 c + r
    holds candidate c; run r of every candidate draws the same coins, as
    greedy runs it)."""
    out = []
    for label, adj in graphs:
        n = adj.shape[0]
        seeds = np.random.default_rng(0).choice(n, 10, replace=False)
        mask = torch.zeros((n, 64), dtype=torch.bool, device=device)
        mask[torch.as_tensor(seeds, device=device)] = True
        out.append((label, adj, mask, 0.1, None))
    hub = hub_graph()
    mask = torch.zeros((hub.shape[0], 64), dtype=torch.bool, device=device)
    mask[torch.arange(64), torch.arange(64)] = True
    out.append(("hub_greedy_chunk", hub,
                mask.repeat_interleave(32, dim=1), 0.2, 32))
    return out


def exact_counts(adj, mask):
    """{0.0: counts at p=0, 1.0: counts at p=1} of the (n, B) seed mask:
    p=0 leaves exactly the seeds, p=1 activates every vertex whose
    connected component holds a seed of the column."""
    from scipy.sparse.csgraph import connected_components

    _, comp = connected_components(adj, directed=False)
    comp = torch.as_tensor(comp, device=mask.device)
    hit = torch.zeros((mask.shape[1], int(comp.max()) + 1), dtype=torch.bool,
                      device=mask.device)
    cols, rows = torch.nonzero(mask.t(), as_tuple=True)
    hit[cols, comp[rows]] = True
    sizes = torch.bincount(comp).to(torch.int64)
    return {0.0: mask.sum(dim=0),
            1.0: (hit.to(torch.int64) * sizes).sum(dim=1)}


def ic_modes(fn, args, lists, want, limit, step_pairs):
    """Phases 22 and 23: the cascade wrapper ``fn`` on ``args`` and the
    push ``lists`` (the gather form's with its chunk list) in each mode of
    IC_MODES against the plain version's result ``want``: per mode
    bit_equal (active words, counts, steps), the launches, the steps and
    dense steps, and the dense steps the plain version's pairs per step
    (``step_pairs``) give at the auto ``limit``. Returns the rows and the
    auto run's result."""
    rows, auto = {}, None
    for mode in IC_MODES:
        stats = {}
        before = fn.launches
        got = fn(*args, lists, mode=mode, stats=stats)
        torch.cuda.synchronize()
        expect = {"push": 0, "dense": len(step_pairs),
                  "auto": sum(d > limit for d in step_pairs)}[mode]
        rows[mode] = dict(
            bit_equal=all(torch.equal(g, w) for g, w in zip(got, want)),
            launches=fn.launches - before, steps=int(got[2]),
            dense_steps=int(stats["dense_steps"]),
            dense_steps_expected=expect)
        if mode == "auto":
            auto = got
    return rows, auto


def ic_modes_ok(rows):
    """Every mode bit-equal, one launch, its dense steps as expected."""
    return all(r["bit_equal"] and r["launches"] == 1
               and r["dense_steps"] == r["dense_steps_expected"]
               for r in rows.values())


def frontier_model_bytes(step_pairs, limit, dense_step_bytes, n, W):
    """The frontier-driven kernels' traffic model of one cascade: the n * W
    state initialized (seed read, active and the three hit buffers
    written, the stamps) and counted once; a push step of D pairs D * (8
    bytes of push list and a 32-byte sector each of the receiver's active
    and two hit words per 8 words); a dense step (more pairs than
    ``limit``) the dense pass's ``dense_step_bytes``."""
    per_pair = 8 + 96 * -(-W // 8)
    total = 24 * n * W + 4 * n
    for d in step_pairs:
        total += dense_step_bytes if d > limit else d * per_pair
    return total


def push_io_bytes(stats, n, W, B):
    """The bytes a cascade must move on its push lists: the seed words and
    the key read, the row starts (two int32) of each vertex that was in
    the frontier (``stats['sources']``) and the receiver and slot (two
    int32) of each pair behind the frontier, once (``stats['pushed']``),
    read; the active words, counts and steps written. The graph's other
    pairs (the rest of the table or edge list) need not be read."""
    return (4 * (2 * n * W + B + 1) + 16 + 8 * stats["sources"]
            + 8 * stats["pushed"])


def push_list_build(build):
    """(lists, ms, bytes) of one push-list build by ``build()`` on the
    card (a second build: the first was the plan's or a first call's)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lists = build()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return lists, ms, 4 * sum(int(x.numel()) for x in lists)


def phase_ic_kernel(fp32_instr_per_s, adj100k, adj1m, device="cuda"):
    """Phase 22: the IC cascade kernel against its plain version on the
    card, bit for bit (active words, counts, steps), at each of ic_cases'
    shapes (the 100K, 1M and heavy-tail 1M plans, each row with its chunk
    count, and the hub graph's greedy chunk) for its p, p=0 and p=1, in
    each mode (push, dense, auto); one
    launch per cascade; the dense steps as the plain version's pairs per
    step give them; p=0 leaves exactly the seeds and p=1 exactly their
    components. At each shape's p the kernel's time per call (auto) and
    back to back (each mode), the plain version's, the push lists' build,
    and the bounds. Returns the 1M shape's numbers for the kernel
    summary."""
    from graphem_rapids_torch.influence import _as_edges_and_n
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_sim as tic

    key = torch.tensor(IC_KEY, dtype=torch.int64, device=device)
    out = {"max_abs_err": 0}
    graphs = [("random_8_regular_100k", adj100k), ("ring_chords_1m", adj1m),
              ("skewed_1m", skewed_graph())]
    for label, adj, mask, p, runs in ic_cases(graphs, device):
        edges, n = _as_edges_and_n(adj)
        plan = tic.build_cascade_plan(edges, n, device)
        table, ptr, src = plan["table"], plan["ov_ptr"], plan["ov_src"]
        n_chunks = int(plan["push"][3].shape[0])
        lists, build_ms, list_bytes = push_list_build(
            lambda: icc.table_push_lists(table, src, plan["ov_dst"], ptr,
                                         n_chunks))
        cap, O, B = table.shape[1], src.shape[0], mask.shape[1]
        W = -(-B // 32)
        limit = icc.table_dense_limit("auto", n, cap, O, W)
        words = icc.pack_columns(mask)
        exact = exact_counts(adj, mask)
        for pp in (p, 0.0, 1.0):
            thr = icc.coin_threshold(pp)
            args = (table, ptr, src, words, key, thr, 200, B, runs)
            stats = {}
            want = icc.ic_cascade_reference(*args, stats=stats)
            modes, got = ic_modes(icc.ic_cascade, args, lists, want, limit,
                                  stats["step_pairs"])
            err = int((got[1] - want[1]).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            steps = int(got[2])
            row = dict(graph=label, n=n, cap=cap, W=W, B=B, O=O,
                       chunks=n_chunks, p=pp, runs=runs, steps=steps,
                       modes=modes,
                       dense_limit=limit, coins=stats["coins"],
                       pushed=stats["pushed"], sources=stats["sources"],
                       step_pairs=stats["step_pairs"],
                       mean_count=float(got[1].double().mean()))
            if pp in exact:
                row["exact"] = bool(torch.equal(got[1].to(torch.int64),
                                                exact[pp].to(torch.int64)))
            if pp == p:
                ms = cuda_ms(lambda: icc.ic_cascade(*args, lists))
                b2b = {m: back_to_back_ms(
                    lambda m=m: icc.ic_cascade(*args, lists, mode=m))
                    for m in IC_MODES}
                plain_ms = cuda_ms(lambda: icc.ic_cascade_reference(*args),
                                   reps=3, warmup=1)
                # each input read once and each output written once, as
                # far as this run's data needs them: the seed words, the
                # key, the push lists' row starts of the vertices that
                # were ever in the frontier and their pairs (8 bytes
                # each), the active words, counts and steps
                io_bytes = push_io_bytes(stats, n, W, B)
                # per dense step: the table, one 32-byte sector per
                # gathered frontier word group, the overflow list and row
                # starts, and the active and frontier words read and
                # written (the table walk of every step)
                step_bytes = (4 * (n * cap + O + n + 1)
                              + 32 * (n * cap + O) * -(-W // 8)
                              + 16 * n * W)
                ops = stats["coins"] * PHILOX_INSTR / 4
                bytes_ms = io_bytes / H100_HBM_BYTES_PER_S * 1e3
                ops_ms = ops / fp32_instr_per_s * 1e3
                bound = max(bytes_ms, ops_ms)
                model = frontier_model_bytes(stats["step_pairs"], limit,
                                             step_bytes, n, W)
                row.update(kernel_ms=ms, back_to_back_ms=b2b["auto"],
                           back_to_back_ms_by_mode=b2b,
                           plain_ms=plain_ms, io_bytes=io_bytes,
                           ops=ops, bound_ms=bound,
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations",
                           push_lists_build_ms=build_ms,
                           push_lists_bytes=list_bytes,
                           frontier_model_bytes=model,
                           frontier_model_ms=model
                           / H100_HBM_BYTES_PER_S * 1e3,
                           step_bytes=step_bytes,
                           step_bytes_ms=steps * step_bytes
                           / H100_HBM_BYTES_PER_S * 1e3,
                           share_of_bound_back_to_back=bound / b2b["auto"])
                if adj is adj1m:
                    out.update(ms=ms, back_to_back_ms=b2b["auto"],
                               plain_ms=plain_ms, bound_ms=bound,
                               bound_by=row["bound_by"])
            emit("ic_kernel", **row)
            if not ic_modes_ok(modes) or not row.get("exact", True):
                raise AssertionError(f"ic_kernel {label} p={pp}: {row}")
        del plan, table, ptr, src, words, lists
    torch.cuda.empty_cache()
    return out


def phase_ic_scatter(fp32_instr_per_s, adj1m, adj12m, device="cuda"):
    """Phase 23, first part: the scatter cascade kernel against its plain
    version on the card, bit for bit (active words, counts, steps), on the
    directed edge lists of the 1M and 12M graphs (10 random seeds in 64
    columns, p=0.1) and of the hub graph's first greedy chunk (B=2048,
    W=64, p=0.2), each also at p=0 and p=1, in each mode (push, dense,
    auto); one launch per cascade; the dense steps as the plain version's
    pairs per step give them; p=0 leaves exactly the seeds and p=1 exactly
    their components. At each shape's p the kernel's time per call (auto)
    and back to back (each mode), the plain version's in the compared run,
    the push lists' build, and the bounds. Returns the 12M shape's numbers
    for the kernel summary."""
    from graphem_rapids_torch.influence import _as_edges_and_n
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_scatter as ics
    from graphem_rapids_torch.ops import ic_sim as tic

    key = torch.tensor(IC_KEY, dtype=torch.int64, device=device)
    out = {"max_abs_err": 0}
    graphs = [("ring_chords_1m", adj1m), ("ring_chords_12m", adj12m)]
    for label, adj, mask, p, runs in ic_cases(graphs, device):
        edges, n = _as_edges_and_n(adj)
        src, dst = tic.directed_edges(edges, device)
        del edges
        ics.edge_push_lists(src, dst, n)  # the build of a first call
        lists, build_ms, list_bytes = push_list_build(
            lambda: ics.edge_push_lists(src, dst, n))
        E2, B = src.shape[0], mask.shape[1]
        W = -(-B // 32)
        limit = icc.dense_limit("auto", E2, ics.DENSE_BETA, W)
        words = icc.pack_columns(mask)
        exact = exact_counts(adj, mask)
        for pp in (p, 0.0, 1.0):
            args = (src, dst, words, key, icc.coin_threshold(pp), 200, B,
                    runs)
            stats = {}
            t0 = time.perf_counter()
            want = ics.ic_scatter_reference(*args, stats=stats)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            modes, got = ic_modes(ics.ic_scatter, args, lists, want, limit,
                                  stats["step_pairs"])
            err = int((got[1] - want[1]).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            steps = int(got[2])
            row = dict(graph=label, n=n, E2=E2, W=W, B=B, p=pp, runs=runs,
                       steps=steps, modes=modes, dense_limit=limit,
                       coins=stats["coins"], attempted=stats["attempted"],
                       pushed=stats["pushed"], sources=stats["sources"],
                       step_pairs=stats["step_pairs"], plain_s=plain_s,
                       mean_count=float(got[1].double().mean()))
            if pp in exact:
                row["exact"] = bool(torch.equal(got[1].to(torch.int64),
                                                exact[pp].to(torch.int64)))
            if pp == p:
                ms = cuda_ms(lambda: ics.ic_scatter(*args, lists))
                b2b = {m: back_to_back_ms(
                    lambda m=m: ics.ic_scatter(*args, lists, mode=m))
                    for m in IC_MODES}
                plain_ms = plain_s * 1e3  # the compared run's
                # each input read once and each output written once, as
                # far as this run's data needs them (as in phase 22)
                io_bytes = push_io_bytes(stats, n, W, B)
                # per dense step: src, one 32-byte sector per edge's
                # frontier row of W words, and the hit and frontier words
                # of a pass over every vertex
                step_bytes = 4 * E2 + 32 * E2 * -(-W // 8) + 8 * n * W
                ops = stats["coins"] * PHILOX_INSTR / 4
                bytes_ms = io_bytes / H100_HBM_BYTES_PER_S * 1e3
                ops_ms = ops / fp32_instr_per_s * 1e3
                bound = max(bytes_ms, ops_ms)
                model = frontier_model_bytes(stats["step_pairs"], limit,
                                             step_bytes, n, W)
                row.update(kernel_ms=ms, back_to_back_ms=b2b["auto"],
                           back_to_back_ms_by_mode=b2b,
                           plain_ms=plain_ms, io_bytes=io_bytes, ops=ops,
                           bound_ms=bound,
                           bound_by="bytes" if bytes_ms >= ops_ms
                           else "operations",
                           push_lists_build_ms=build_ms,
                           push_lists_bytes=list_bytes,
                           frontier_model_bytes=model,
                           frontier_model_ms=model
                           / H100_HBM_BYTES_PER_S * 1e3,
                           step_bytes=step_bytes,
                           step_bytes_ms=steps * step_bytes
                           / H100_HBM_BYTES_PER_S * 1e3,
                           share_of_bound_back_to_back=bound / b2b["auto"])
                if adj is adj12m:
                    out.update(ms=ms, back_to_back_ms=b2b["auto"],
                               plain_ms=plain_ms, bound_ms=bound,
                               bound_by=row["bound_by"])
            emit("ic_scatter", **row)
            if not ic_modes_ok(modes) or not row.get("exact", True):
                raise AssertionError(f"ic_scatter {label} p={pp}: {row}")
            del got, want
        del src, dst, words, mask, lists
        torch.cuda.empty_cache()
    return out


def phase_scatter_main(grt, adj, profile):
    """Phase 23, second part: the scatter path through the public entry
    point. estimated_influence of 10 random vertices on the 12M graph at
    p=0.1 over 64 runs, timed with its split (edge extraction, the plan
    decision, the directed edge lists' build and upload, the device part) and
    its peak device memory, then at p=0 (exactly the seeds) and p=1 (all
    12M vertices, the ring is connected): three cascades, three
    ic_scatter launches and no ic_cascade launch. Returns the launches."""
    from graphem_rapids_torch.ops import ic_cascade as icc
    from graphem_rapids_torch.ops import ic_scatter as ics

    n = adj.shape[0]
    seeds = np.random.default_rng(0).choice(n, 10, replace=False).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    icc.ic_cascade.launches = 0
    ics.ic_scatter.launches = 0
    with program_split(IC_SPANS) as split:
        t0 = time.perf_counter()
        spread = grt.estimated_influence(adj, seeds, p=0.1, num_sims=64)
        ic_s = time.perf_counter() - t0
    split["other_s"] = ic_s - sum(split.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    p0 = grt.estimated_influence(adj, seeds, p=0.0, num_sims=64)
    p1 = grt.estimated_influence(adj, seeds, p=1.0, num_sims=64)
    launches, gather = ics.ic_scatter.launches, icc.ic_cascade.launches
    emit("scatter_influence", graph="ring_chords_12m", n=n,
         E=int(adj.nnz // 2), p=0.1, num_sims=64, ic_seconds=ic_s,
         split=split, peak_mem_gib=peak, spread=spread, p0_spread=p0,
         p1_spread=p1, cascades=3, ic_scatter_launches=launches,
         ic_cascade_launches=gather)
    if p0 != 10.0 or p1 != float(n) or not 10.0 <= spread < n:
        raise AssertionError(f"scatter path: p=0 -> {p0} (want 10), p=1 -> "
                             f"{p1} (want {n}), p=0.1 -> {spread}")
    if launches != 3 or gather != 0:
        raise AssertionError(f"scatter path: {launches} ic_scatter and "
                             f"{gather} ic_cascade launches for 3 cascades")
    if profile:
        profile_call(
            "profile_ic", "ring_chords_12m",
            lambda: grt.estimated_influence(adj, seeds, p=0.1, num_sims=64),
            lambda: grt.estimated_influence(adj, seeds, p=0.1, num_sims=64),
            ic_s * 1e3, 1)
    return launches


def phase_scale_main(grt, bf, adj, fp32_instr_per_s, iters=20):
    """Phase 27: the main path on phase 23's 12M graph (init='random',
    the JAX scale scripts' settings), past K1's 2^24-ref bound: the
    strategy must be fused binfold over n_seg >= 2 segments. On one step's
    queries and fused refs (a sample of the phase's own) the segmented K1
    against the plain per-segment fold (64 query rows a call) and the same
    merge: each segment's bins and the merged (index, distance) pairs
    bit-equal; its time per call and back to back (the whole segmented
    call and the folds alone) beside its bound. Then run_layout: the
    eager first iteration and the capture, two replayed iterations against
    the eager step from the same start on each replay's sample, bit-equal,
    and ``iters`` replayed iterations with the counts zeroed just before:
    n_seg K1 launches and one cluster launch an iteration, finite
    positions of std ~1. Returns the K1 launches and the K1 fields of the
    segmented shape."""
    from graphem_rapids_torch.ops.sampling import sample_indices

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with program_split(SETUP_SPANS) as split:
        t0 = time.perf_counter()
        emb = grt.GraphEmbedderTorch(adj, n_components=3, seed=0,
                                     verbose=False, init="random",
                                     **FORCE_PARAMS)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    split["other_s"] = init_s - sum(split.values())
    R, k = int(len(emb._nb["ref_edge"])), emb._k_eff
    T, G = bf.params_for(k, emb.knn_recall_target)
    seg, n_seg = bf.segments(R, T)
    emit("scale_setup", graph="ring_chords_12m", n=emb.n, E=emb.n_edges,
         table=emb.table_kind, strategy=emb._strategy,
         fused_refs=emb._fused_refs_active, refs=R, segment=seg,
         n_seg=n_seg, init_s=init_s, split=split,
         setup_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if (emb._strategy != "binfold" or not emb._fused_refs_active
            or n_seg < 2):
        raise AssertionError(f"scale_main: {emb._strategy}, fused "
                             f"{emb._fused_refs_active}, {n_seg} segments: "
                             "want fused binfold over >= 2 segments")

    gen = torch.Generator(device="cuda").manual_seed(27)
    sampled = sample_indices(gen, emb.n_edges, emb.sample_size,
                             device=emb.device)
    queries, refs = step_knn_inputs(emb, sampled)
    bf.knn_binfold.launches = 0
    got_i, got_v = bf.knn_binfold(queries, refs, k)
    call_launches = bf.knn_binfold.launches
    folds = []
    kernel_fold = bf.binfold_bins

    def plain_fold(q, r, T_, G_, n_super):
        parts = [bf.binfold_bins_reference(q[i:i + 64], r, T_, G_, n_super)
                 for i in range(0, q.shape[0], 64)]
        pv = torch.cat([v for v, _ in parts])
        pi = torch.cat([i for _, i in parts])
        folds.append((r, G_, n_super, pv, pi))
        return pv, pi

    bf.binfold_bins = plain_fold
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_i, want_v = bf.knn_binfold(queries, refs, k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bf.binfold_bins = kernel_fold
    rows, err = [], 0.0
    for r, G_, n_super, pv, pi in folds:
        kv, ki = bf.binfold_bins_cuda(queries, r, T, G_, n_super)
        err = max(err, float((kv - pv).abs().max()))
        rows.append(dict(E=r.shape[0], G=G_, n_super=n_super,
                         bins_bit_equal=bool(torch.equal(kv, pv)
                                             and torch.equal(ki, pi))))
    merged = bool(torch.equal(got_i, want_i) and torch.equal(got_v, want_v))
    # each segment's refs and geometry, as the segmented call folds them
    plan = [(r, (g, ns)) for r, g, ns, _, _ in folds]
    del folds
    S, d = queries.shape
    ms = cuda_ms(lambda: bf.knn_binfold(queries, refs, k))
    b2b = back_to_back_ms(lambda: bf.knn_binfold(queries, refs, k))
    b2b_folds = back_to_back_ms(
        lambda: [bf.binfold_bins_cuda(queries, r, T, g, ns)
                 for r, (g, ns) in plan])
    # per pair 3d + 2 fp32 instructions, as phase 3 counts them
    ops = sum((3 * d + 2) * S * ns * g * T for _, (g, ns) in plan)
    nbytes = 4 * (S * d + R * d) + sum(8 * S * g * 128 for _, (g, _) in plan)
    ops_ms = ops / fp32_instr_per_s * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    k1 = dict(S=S, refs=R, n_seg=n_seg, segment=seg, ms=ms,
              back_to_back_ms=b2b, folds_back_to_back_ms=b2b_folds,
              plain_ms=plain_ms, ops=ops, bytes=nbytes, ops_bound_ms=ops_ms,
              bytes_bound_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
              share_of_bound_back_to_back=max(ops_ms, bytes_ms) / b2b_folds,
              max_abs_err=err)
    emit("scale_kernel", name="knn_binfold", graph="ring_chords_12m",
         launches_per_call=call_launches, segments=rows,
         merged_bit_equal=merged, **k1)
    if (call_launches != n_seg or not merged
            or not all(r["bins_bit_equal"] for r in rows)):
        raise AssertionError(f"scale_main: segmented K1 against its plain "
                             f"version: {call_launches} launches for "
                             f"{n_seg} segments, merged {merged}, {rows}")
    del queries, refs, got_i, got_v, want_i, want_v, plan

    emb.run_layout(1)  # the eager first iteration, then the capture
    if emb._graph is None:
        raise AssertionError("scale_main: run_layout did not capture")
    p = emb._positions.clone()
    replay_equal = True
    for _ in range(2):
        emb._iterate(1)
        p = emb._raw_step(p, emb._graph_sample)
        replay_equal &= bool(torch.equal(p, emb._positions))
    emb._iteration += 2
    del p
    per_iter = (emb._ops["ov_plan"] is not None) + (
        emb._ops["nb_overflow"] is not None)
    torch.cuda.reset_peak_memory_stats()
    bf.knn_binfold.launches = 0
    with segment_launches("ring_chords_12m", iters, per_iter) as seg_count:
        t0 = time.perf_counter()
        pos = emb.run_layout(iters, block_size=iters)
        dt = time.perf_counter() - t0
    launches = bf.knn_binfold.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    emb._iterate(10)
    ev[1].record()
    torch.cuda.synchronize()
    emb._iteration += 10
    # in float64: a float32 sum over 12M rows loses the low terms
    std = pos.astype(np.float64).std(axis=0, ddof=1)
    emit("scale_main", graph="ring_chords_12m", n=emb.n, E=emb.n_edges,
         n_seg=n_seg, iters=iters, replay_vs_eager_iters=2,
         replay_bit_equal=replay_equal, binfold_launches=launches,
         segment_cluster_launches=seg_count["cluster_launches"],
         segment_sum_launches=seg_count["launches"], seconds=dt,
         ms_per_iter=dt / iters * 1e3,
         device_ms_per_iter=ev[0].elapsed_time(ev[1]) / 10,
         edges_per_s=emb.n_edges * iters / dt, peak_mem_gib=peak,
         reserved_gib=torch.cuda.memory_reserved() / 2**30,
         finite=bool(np.isfinite(pos).all()), std=std.tolist(),
         phase_seconds=time.perf_counter() - t_phase)
    if launches != iters * n_seg:
        raise AssertionError(f"scale_main: {launches} K1 launches in {iters} "
                             f"iterations of {n_seg} segments")
    if not replay_equal:
        raise AssertionError("scale_main: replay differs from the eager step")
    if pos.shape != (emb.n, 3) or not np.isfinite(pos).all():
        raise AssertionError("scale_main: positions not finite")
    if not np.allclose(std, 1.0, atol=1e-3):
        raise AssertionError(f"scale_main: per-axis std {std} is not ~1")
    del emb, pos
    torch.cuda.empty_cache()
    return launches, k1


# the accumulator's sum and tile sort launches on each layout path (phases
# 5-7, 11, 15, 17, 18), for the kernel summary
PATH_SEGMENT_LAUNCHES = []
PATH_SORT_LAUNCHES = []
PATH_CLUSTER_LAUNCHES = []


@contextlib.contextmanager
def segment_launches(label, iters, static_per_iter=None, form="cluster"):
    """Zero the accumulator's launch counts, run the block, read them: the
    step's dynamic sum takes exactly one cluster launch an iteration and no
    tile sort (``form`` 'cluster', every engine's step up to the cluster's
    capacity), or one tile sort and one tiled sum an iteration ('tiled');
    the static form's sums (a hub block plan, the COO overflow tails)
    exactly ``static_per_iter`` an iteration where given. Yields a dict
    that receives 'cluster_launches', 'launches' (the tiled and static
    sum's) and 'sort_launches'."""
    from graphem_rapids_torch.ops import segment as seg

    seg.segment_sum_cluster.launches = 0
    seg.segment_sum.launches = seg.sort_tiles.launches = 0
    got = {}
    yield got
    got["cluster_launches"] = n_cluster = seg.segment_sum_cluster.launches
    got["launches"] = n = seg.segment_sum.launches
    got["sort_launches"] = n_sort = seg.sort_tiles.launches
    PATH_CLUSTER_LAUNCHES.append(n_cluster)
    PATH_SEGMENT_LAUNCHES.append(n)
    PATH_SORT_LAUNCHES.append(n_sort)
    tiled = iters if form == "tiled" else 0
    want = (None if static_per_iter is None
            else static_per_iter * iters + tiled)
    if (n_cluster != iters - tiled or n_sort != tiled or n < tiled
            or (want is not None and n != want)):
        raise AssertionError(
            f"{label}: {n_cluster} cluster launches, {n_sort} tile sorts and "
            f"{n} sums in {iters} iterations, want {iters - tiled}, {tiled} "
            f"and {want if want is not None else '>= ' + str(tiled)}")


def chebyshev_fields(log, label, expected):
    """The Chebyshev tier's seconds and Ritz values from its log record;
    fails on a tier-down, or if the tier ran other than ``expected``
    times."""
    runs = [r for r in log.take(label) if hasattr(r, "ritz")]
    if len(runs) != expected:
        raise AssertionError(f"{label}: the Chebyshev tier ran {len(runs)} "
                             f"times, expected {expected}")
    if not runs:
        return {}
    return dict(chebyshev_s=runs[0].chebyshev_seconds, ritz=runs[0].ritz,
                spmv_overflow=runs[0].overflow,
                spmv_overflow_pairs=runs[0].overflow_pairs)


def phase_main(grt, bf, label, adj, expect_table, init, warmup, profile,
               log, checked, **engine_kw):
    """Phases 5/6 (and 18 with ref_order='slot'): construct, warm up (the
    first iteration, then the capture of the replayed graph), then the
    timed run_layout. Returns the run for phase 24: its K1 launches, its
    engine's options, its start and its positions after ``iters``."""
    from graphem_rapids_torch import native as fg

    for fn in fg.NATIVE:
        fn.calls = 0
    torch.cuda.reset_peak_memory_stats()
    with program_split(SETUP_SPANS) as split:
        t0 = time.perf_counter()
        emb = grt.GraphEmbedderTorch(adj, n_components=3, seed=0,
                                     verbose=False, init=init,
                                     **FORCE_PARAMS, **engine_kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    split["other_s"] = init_s - sum(split.values())
    start = emb.positions
    calls = helper_calls(fg)
    device_tier = init == "chebyshev" or (init == "auto"
                                          and emb.n >= 500_000)
    emit("main_setup", graph=label, n=emb.n, E=emb.n_edges,
         table=emb.table_kind, ref_order=emb.ref_order,
         strategy=emb._strategy,
         fused_refs=emb._fused_refs_active,
         refs=int(len(emb._nb["ref_edge"])),
         overflow_pairs=int(len(emb._nb["overflow"])), init=init,
         init_s=init_s, split=split, native_calls=calls,
         setup_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         **chebyshev_fields(log, label, int(device_tier)))
    if not (calls["csr_lt_edges_native"] and calls["radix_argsort_native"]):
        raise AssertionError(f"{label}: the set-up did not run the C "
                             f"helpers: {calls}")
    if emb.table_kind != expect_table:
        raise AssertionError(f"{label}: table {emb.table_kind}, "
                             f"expected {expect_table}")
    if emb._strategy != "binfold" or not emb._fused_refs_active:
        raise AssertionError(f"{label}: main path must take fused binfold")
    # the capture's K1 shapes are the replayed ones: record from warm-up on
    # the accumulator's static sums: the hub block plan, the COO tails
    per_iter = (emb._ops["ov_plan"] is not None) + (
        emb._ops["nb_overflow"] is not None)
    with k1_shapes(bf, checked, label) as shapes:
        emb.run_layout(warmup, block_size=warmup)
        if emb._graph is None:
            raise AssertionError(f"{label}: run_layout did not capture")
        bf.knn_binfold.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with segment_launches(label, ITERS, per_iter) as seg_count:
            t0 = time.perf_counter()
            pos = emb.run_layout(ITERS, block_size=10)
            dt = time.perf_counter() - t0
        launches = bf.knn_binfold.launches
    std = pos.std(axis=0, ddof=1)
    emit("main_run", graph=label, ref_order=emb.ref_order, iters=ITERS,
         binfold_shapes=sorted(shapes), seconds=dt,
         ms_per_iter=dt / ITERS * 1e3, edges_per_s=emb.n_edges * ITERS / dt,
         binfold_launches=launches,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         # the graph's pool holds the step's temporaries between replays
         reserved_gib=torch.cuda.memory_reserved() / 2**30,
         finite=bool(np.isfinite(pos).all()), std=std.tolist())
    if launches != ITERS:
        raise AssertionError(f"{label}: {launches} kernel launches in "
                             f"{ITERS} iterations")
    if pos.shape != (emb.n, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite")
    if not np.allclose(std, 1.0, atol=1e-3):
        raise AssertionError(f"{label}: per-axis std {std} is not ~1")
    run = dict(label=label, adj=adj, init=init, engine_kw=engine_kw,
               iters=warmup + ITERS, start=start, end=pos,
               launches=launches)
    if profile:
        profile_steps(emb, label, dt / ITERS * 1e3)
    return run


def phase_card_vs_cpu(grt, strategy, ref_order="row"):
    """Phase 9: the same injected-sample steps on the card and the CPU.
    Returns the card's positions and the max abs error."""
    adj = regular_union_graph(2000, cycles=3, seed=1)
    kw = dict(n_components=3, seed=0, verbose=False, init="scipy",
              knn_strategy=strategy, ref_order=ref_order, **FORCE_PARAMS)
    gpu = grt.GraphEmbedderTorch(adj, device="cuda", **kw)
    cpu = grt.GraphEmbedderTorch(adj, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for _ in range(5):
        s = rng.permutation(gpu.n_edges)[:gpu.sample_size]
        gpu.update_positions(sample_indices=s)
        cpu.update_positions(sample_indices=s)
    a, b = gpu.positions, cpu.positions
    err = float(np.abs(a - b).max())
    ok = bool(np.allclose(a, b, rtol=1e-4, atol=1e-5))
    emit("card_vs_cpu", strategy=strategy, ref_order=ref_order,
         resolved=gpu._strategy, fused_refs=gpu._fused_refs_active, n=gpu.n,
         E=gpu.n_edges, steps=5, max_abs_err=err, rtol=1e-4, atol=1e-5,
         allclose=ok)
    if not ok or gpu._strategy != strategy:
        raise AssertionError(f"card and CPU trajectories disagree ({strategy}"
                             f", {ref_order})")
    return a, err


def max_diff(a, b):
    """Largest |a - b| over two arrays of one shape (0.0 when equal)."""
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def seeded_twin(grt, run, resume_at=25):
    """A second engine of ``run``'s seed and options (``run`` as phase_main
    returns it): its start, and its positions after the run's iterations,
    against the run's; its checkpoint after ``resume_at`` replayed
    iterations, loaded into a third engine and run ``resume_at`` more,
    against its own positions after 2 * ``resume_at``, which are also held
    against the run's ``mid`` where it has one. Returns (the row of max
    abs differences and bit-equalities, the twin engine)."""
    kw = dict(n_components=3, seed=0, verbose=False, **FORCE_PARAMS,
              **run["engine_kw"])
    twin = grt.GraphEmbedderTorch(run["adj"], init=run["init"], **kw)
    start = twin.positions
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt.npz")
        twin.run_layout(resume_at, block_size=resume_at)
        twin.save_checkpoint(ckpt)
        straight = twin.run_layout(resume_at, block_size=resume_at)
        # the start is the checkpoint's: a random init costs nothing
        resumed = grt.GraphEmbedderTorch(run["adj"], init="random", **kw)
        resumed.load_checkpoint(ckpt)
        back = resumed.run_layout(resume_at, block_size=resume_at)
        del resumed
    end = twin.run_layout(run["iters"] - 2 * resume_at, block_size=10)
    row = dict(graph=run["label"], n=twin.n, E=twin.n_edges,
               table=twin.table_kind, init=run["init"], iters=run["iters"],
               start_bit_equal=bool(np.array_equal(start, run["start"])),
               start_max_diff=max_diff(start, run["start"]),
               end_bit_equal=bool(np.array_equal(end, run["end"])),
               end_max_diff=max_diff(end, run["end"]),
               resume_at=resume_at,
               resume_bit_equal=bool(np.array_equal(back, straight)),
               resume_max_diff=max_diff(back, straight))
    if "mid" in run:
        row.update(mid_iters=2 * resume_at,
                   mid_bit_equal=bool(np.array_equal(straight, run["mid"])),
                   mid_max_diff=max_diff(straight, run["mid"]))
    return row, twin


# the accumulator calls of one eager step of each layout path, for
# phase 25: (path, 'dynamic' or 'static', out, ids or keys, values, perm)
RECORDED_SUMS = []


@contextlib.contextmanager
def recorded_sums():
    """Record every accumulator call of the step ops and the sharded step
    (copies of its inputs) while the block runs: ('dynamic' or 'static',
    out, ids or keys, values, perm)."""
    from graphem_rapids_torch.ops import forces
    from graphem_rapids_torch.parallel import sharded_step

    calls = []
    dynamic, static = forces.segment_sum, forces.segment_sum_sorted
    modules = (forces, sharded_step)

    def dyn(out, ids, values):
        calls.append(("dynamic", out.clone(), ids.clone(), values.clone(),
                      None))
        return dynamic(out, ids, values)

    def sta(out, keys, values, perm=None):
        calls.append(("static", out.clone(), keys.clone(), values.clone(),
                      None if perm is None else perm.clone()))
        return static(out, keys, values, perm)

    for m in modules:
        m.segment_sum, m.segment_sum_sorted = dyn, sta
    try:
        yield calls
    finally:
        for m in modules:
            m.segment_sum, m.segment_sum_sorted = dynamic, static


def record_step(emb, label):
    """Record the accumulator calls of one eager step of ``emb`` (a fixed
    sample; the engine's positions are left as they are) into
    RECORDED_SUMS under ``label``."""
    sample = np.random.default_rng(0).permutation(
        emb.n_edges)[:emb.sample_size]
    with recorded_sums() as got:
        emb._raw_step(emb._positions, torch.as_tensor(
            sample, device=emb.device).to(torch.int32))
    if not any(kind == "dynamic" for kind, *_ in got):
        raise AssertionError(f"{label}: no dynamic accumulator call in a "
                             "step")
    RECORDED_SUMS.extend((label, *c) for c in got)


def phase_determinism(grt, runs, card9):
    """Phase 24: each main-path run's seeded twin and resumed engine
    (seeded_twin), and phase 9's 'pallas' case again against ``card9``
    (its first run's card positions and max_abs_err). Records the
    accumulator calls of one step of each twin, for phase 25."""
    for run in runs:
        row, twin = seeded_twin(grt, run)
        emit("determinism", **row)
        if not (row["start_bit_equal"] and row["end_bit_equal"]
                and row["resume_bit_equal"]):
            raise AssertionError(f"{run['label']}: one seed, two layouts: "
                                 f"{row}")
        record_step(twin, run["label"])
        del twin
    pos, err = phase_card_vs_cpu(grt, "pallas")
    row = dict(strategy="pallas", positions_bit_equal=bool(
        np.array_equal(pos, card9[0])), max_abs_err=err,
        first_max_abs_err=card9[1],
        positions_max_diff=max_diff(pos, card9[0]))
    emit("determinism_card_vs_cpu", **row)
    if not (row["positions_bit_equal"] and err == card9[1]):
        raise AssertionError(f"phase 9 'pallas' twice: {row}")


def deterministic(fn):
    """``fn`` under torch.use_deterministic_algorithms(True), the global
    setting restored after it: ``index_add_`` on a card then takes the
    sorted ``index_put_`` instead of float atomics."""
    def run(*args):
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return fn(*args)
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn)
    return run


def library_times(fn, out, want, o):
    """A library call's ms per call and replayed on the scratch ``o``
    (None, with the error, where it cannot be captured), and whether
    ``fn`` on a copy of ``out`` is bit-equal to ``want``."""
    row = dict(bit_equal_cpu=bool(torch.equal(fn(out.clone()).cpu(), want)),
               ms=cuda_ms(lambda: fn(o)))
    try:
        row["replayed_ms"] = replayed_ms(lambda: fn(o))
    except RuntimeError as exc:
        row.update(replayed_ms=None, capture_error=str(exc)[:200])
    return row


def tiled_fields(seg, ids, ids_c, values, rows, o, mem_bytes_per_s,
                 fp32_instr_per_s):
    """The tiled form on ``ids``: its tile sort against its plain version,
    both kernels' times, and the sort's bound."""
    keys, order, T, L, mask = seg.sort_tiles(ids, rows)
    ref = seg.sort_tiles_reference(ids_c, rows)
    got_sort = (keys.cpu(), order.cpu(), None if mask is None else mask.cpu())
    want_sort = (ref[0], ref[1], ref[4])
    err_s = 0.0 if (T, L) == ref[2:4] else float("inf")
    for x, y in zip(got_sort, want_sort):
        if (x is None) != (y is None) or (
                x is not None and x.shape != y.shape):
            err_s = float("inf")
        elif x is not None and x.numel():
            err_s = max(err_s, float((x.double() - y.double()).abs().max()))
    padded = torch.full((T * L,), seg.PAD_KEY, dtype=torch.int32,
                        device=ids.device)
    padded[:len(ids)] = ids.to(torch.int32)
    mask_words_set = int((mask != 0).sum()) if mask is not None else 0
    sort_bytes = (ids.numel() * ids.element_size() + T * L * (4 + 8)
                  + mask_words_set * 8)
    # a bitonic sort of 1,024 slots: 55 compare-exchange stages
    sort_ops = T * seg.TILE * 55
    bound_bytes = sort_bytes / mem_bytes_per_s * 1e3
    bound_ops = sort_ops / fp32_instr_per_s * 1e3

    def tiled():
        k, p, t, _, m = seg.sort_tiles(ids, rows)
        return seg.segment_sum_cuda(o, k, values, p, tiles=t, mask=m)

    return dict(
        tiles=T, tile_len=L, mask_words=seg.mask_words(T) if T > 1 else 0,
        sort_max_abs_err=err_s,
        sort_kernel_ms=cuda_ms(lambda: seg.sort_tiles(ids, rows)),
        sort_back_to_back_ms=back_to_back_ms(
            lambda: seg.sort_tiles(ids, rows)),
        sort_replayed_ms=replayed_ms(lambda: seg.sort_tiles(ids, rows)),
        sort_plain_ms=cpu_ms(lambda: seg.sort_tiles_reference(ids_c, rows),
                             reps=3, warmup=0),
        sort_library_ms=cuda_ms(lambda: torch.sort(padded.view(T, L), dim=1,
                                                   stable=True)),
        sort_io_bytes=sort_bytes, sort_compare_exchanges=sort_ops,
        sort_bound_ms=max(bound_bytes, bound_ops),
        sort_bound_by="bytes" if bound_bytes >= bound_ops else "operations",
        sum_replayed_ms=replayed_ms(lambda: seg.segment_sum_cuda(
            o, keys, values, order, tiles=T, mask=mask)),
        tiled_replayed_ms=replayed_ms(tiled))


def phase_tiled(grt, label, adj, iters=20):
    """Phase 26: the tiled form on a layout path. With sample_size=3072 the
    intersection repulsion's 4*S*k = 184,320 terms pass the cluster's
    capacity: run_layout under replay takes one tile sort and one tiled sum
    an iteration and no cluster launch. One step's calls and the unplanned
    spring_forces of the graph (2E terms) are recorded for phase 25."""
    import scipy.sparse as sp

    from graphem_rapids_torch.ops import forces

    emb = grt.GraphEmbedderTorch(adj, n_components=3, seed=0, verbose=False,
                                 init="random",
                                 **dict(FORCE_PARAMS, sample_size=3072))
    emb.run_layout(3, block_size=3)
    if emb._graph is None:
        raise AssertionError(f"{label}: run_layout did not capture")
    with segment_launches(f"{label} sample_size=3072", iters,
                          form="tiled") as seg_count:
        t0 = time.perf_counter()
        pos = emb.run_layout(iters, block_size=10)
        dt = time.perf_counter() - t0
    emit("tiled_run", graph=label, sample_size=emb.sample_size, iters=iters,
         ms_per_iter=dt / iters * 1e3, strategy=emb._strategy,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         sort_launches=seg_count["sort_launches"],
         finite=bool(np.isfinite(pos).all()))
    if not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite")
    record_step(emb, f"{label} sample_size=3072")
    del emb
    e = np.column_stack(sp.triu(adj, 1).nonzero())
    positions = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (adj.shape[0], 3)).astype(np.float32)).cuda()
    with recorded_sums() as got:
        forces.spring_forces(positions, torch.from_numpy(e).cuda(),
                             FORCE_PARAMS["k_attr"], FORCE_PARAMS["L_min"])
    RECORDED_SUMS.extend((f"{label} spring_forces", *c) for c in got)


def phase_kernel_segment(seg, calls, mem_bytes_per_s, fp32_instr_per_s,
                         clock_hz, long_label):
    """Phase 25: the accumulator's kernels against their plain versions on
    the CPU, on the calls recorded from every layout path and the heavy-tail
    graph's two hub plans. Returns the kernel summaries of the cluster
    kernel (the first cluster-form call recorded: the intersection
    repulsion's 30,720 terms into 100K rows), of the static sum (the call
    labelled ``long_label``: the heavy-tail graph's step plan, whose widest
    hub is the longest run) and of the tile sort (the first call past the
    cluster's capacity), each with the largest error over every call of its
    kernel. A static call also gives its order floor: its longest run of
    dependent adds at FADD_CYCLES each and ``clock_hz``."""
    most = seg.cluster_max_terms(torch.device("cuda"))
    summary = {}
    err = {"cluster": 0.0, "sum": 0.0, "sort": 0.0}
    for label, kind, out, ids, values, perm in calls:
        form = kind if kind == "static" else (
            "cluster" if len(ids) <= most else "tiled")

        def kernel(o):
            if kind == "dynamic":
                return seg.segment_sum(o, ids, values)
            return seg.segment_sum_sorted(o, ids, values, perm)

        out_c, ids_c, values_c = out.cpu(), ids.cpu(), values.cpu()
        perm_c = None if perm is None else perm.cpu()
        want = seg.segment_sum_reference(out_c.clone(), ids_c, values_c,
                                         perm_c)
        counts = (seg.segment_sum_cluster.launches, seg.segment_sum.launches,
                  seg.sort_tiles.launches)
        a, b = kernel(out.clone()), kernel(out.clone())
        launches = tuple(x - y for x, y in zip(
            (seg.segment_sum_cluster.launches, seg.segment_sum.launches,
             seg.sort_tiles.launches), counts))
        a, b = a.cpu(), b.cpu()
        e = float((a - want).abs().max()) if want.numel() else 0.0
        bit_equal = bool(torch.equal(a, want) and torch.equal(a, b))
        fields = {}
        if form == "cluster":
            plain = seg.segment_sum_cluster_reference(out_c.clone(), ids_c,
                                                      values_c)
            fields["bit_equal_plain"] = bool(torch.equal(a, plain))
            bit_equal = bit_equal and fields["bit_equal_plain"]
            plain_ms = cpu_ms(lambda: seg.segment_sum_cluster_reference(
                out_c.clone(), ids_c, values_c))
        else:
            # the plain version is the CPU's index_add_, on the CPU's copies
            plain_ms = cpu_ms(lambda: seg.segment_sum_reference(
                out_c.clone(), ids_c, values_c, perm_c))
        # in place on a scratch copy: the sums grow, which costs no time
        o = out.clone()
        ms = cuda_ms(lambda: kernel(o))
        b2b = back_to_back_ms(lambda: kernel(o))
        replayed = replayed_ms(lambda: kernel(o))
        src = values if perm is None else values[perm]
        library = library_times(lambda x: x.index_add_(0, ids, src), out,
                                want, o)
        library_det = library_times(deterministic(
            lambda x: x.index_add_(0, ids, src)), out, want, o)
        rows = out.shape[0]
        if form != "static":
            # the plain-torch form the kernels were weighed against
            offsets_at = torch.arange(rows + 1, dtype=torch.int32,
                                      device=out.device)

            def reduce_form():
                keys, order = torch.sort(ids.to(torch.int32), stable=True)
                offsets = torch.searchsorted(keys, offsets_at)
                return torch.segment_reduce(
                    values[order].reshape(len(ids), -1), "sum",
                    offsets=offsets, unsafe=True)

            fields.update(
                segment_reduce_replayed_ms=replayed_ms(reduce_form),
                segment_reduce_bit_equal=bool(torch.equal(
                    out.cpu() + reduce_form().reshape(out.shape).cpu(),
                    want)) if not out.any() else None)
            # the tiled form at every dynamic call, for comparison
            fields.update(tiled_fields(seg, ids, ids_c, values, rows, o,
                                       mem_bytes_per_s, fp32_instr_per_s))
            err["sort"] = max(err["sort"], fields["sort_max_abs_err"])
        touched = int(np.unique(ids_c.numpy()).size)
        if form == "static":
            _, runs = torch.unique_consecutive(ids_c, return_counts=True)
            longest = int(runs.max()) if runs.numel() else 0
            fields.update(longest_run=longest,
                          order_bound_ms=longest * FADD_CYCLES / clock_hz
                          * 1e3)
        d = out.shape[1] if out.ndim == 2 else 1
        io_bytes = (ids.numel() * ids.element_size()
                    + (0 if perm is None else perm.numel() * 8)
                    + values.numel() * 4 + 2 * touched * d * 4)
        bound = io_bytes / mem_bytes_per_s * 1e3
        emit("kernel_segment_sum", path=label, form=form, terms=len(ids),
             rows=rows, d=d, touched_rows=touched,
             cluster_launches=launches[0], sum_launches=launches[1],
             sort_launches=launches[2], bit_equal_cpu_index_add=bit_equal,
             max_abs_err=e, kernel_ms=ms, back_to_back_ms=b2b,
             replayed_ms=replayed, plain_ms=plain_ms, library=library,
             deterministic_library=library_det, io_bytes=io_bytes,
             bound_ms=bound, bound_by="bytes", **fields)
        want_launches = {"cluster": (2, 0, 0), "tiled": (0, 2, 2),
                         "static": (0, 2, 0)}[form]
        if not bit_equal or launches != want_launches or \
                fields.get("sort_max_abs_err", 0.0) != 0.0:
            raise AssertionError(
                f"segment_sum {label} {form}: not bit-equal to the CPU's "
                f"index_add_ and its plain version (err {e}), or the tile "
                f"sort not equal to its plain version, or launches "
                f"{launches} (cluster, sum, sort) for 2 calls, want "
                f"{want_launches}")
        key = {"cluster": "cluster", "static": "sum", "tiled": "sort"}[form]
        err[key] = max(err[key], e)
        if key not in summary and (key != "sum" or label == long_label):
            summary[key] = dict(
                ms=ms, back_to_back_ms=b2b, replayed_ms=replayed,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=library["ms"],
                library_replayed_ms=library["replayed_ms"],
                deterministic_library_ms=library_det["ms"],
                deterministic_library_replayed_ms=library_det["replayed_ms"],
                deterministic_library_bit_equal=library_det["bit_equal_cpu"])
            if key == "sum":
                summary[key].update(
                    path=label, terms=len(ids), d=d,
                    longest_run=fields["longest_run"],
                    order_bound_ms=fields["order_bound_ms"])
            if key == "sort":
                summary[key] = dict(
                    ms=fields["sort_kernel_ms"],
                    back_to_back_ms=fields["sort_back_to_back_ms"],
                    replayed_ms=fields["sort_replayed_ms"],
                    plain_ms=fields["sort_plain_ms"],
                    bound_ms=fields["sort_bound_ms"],
                    bound_by=fields["sort_bound_by"],
                    library_ms=fields["sort_library_ms"])
    missing = {"cluster", "sum", "sort"} - set(summary)
    if missing:
        raise AssertionError(f"segment_sum: no recorded call of {missing}")
    paths = sorted({label for label, *_ in calls})
    emit("kernel_segment_sum_paths", paths=paths, calls=len(calls),
         cluster_max_terms=most,
         cluster_groups=seg.cluster_groups(torch.device("cuda")),
         max_abs_err=err)
    return {k: dict(max_abs_err=err[k], **v) for k, v in summary.items()}


def eager_steps(emb, n):
    """``n`` iterations of the eager loop (the CPU's) on ``emb``, drawn
    from its generator; returns each iteration's sample."""
    out = []
    for _ in range(n):
        s = emb._sample()
        out.append(s.cpu().numpy())
        emb._positions = emb._raw_step(emb._positions, s)
    return out


def phase_graph_vs_eager(grt, label, adj, iters=5, **engine_kw):
    """Phase 16: ``iters`` replayed iterations against as many eager ones
    from the same generator state and the same start, both engines on the
    card, with their own sums: bit-equal samples every iteration and
    bit-equal positions."""
    kw = dict(n_components=3, seed=0, verbose=False, init="random",
              **FORCE_PARAMS, **engine_kw)
    replayed = grt.GraphEmbedderTorch(adj, device="cuda", **kw)
    eager = grt.GraphEmbedderTorch(adj, device="cuda", **kw)
    replayed.run_layout(1)  # the eager first iteration, then the capture
    eager_steps(eager, 1)
    samples_equal, positions_equal, err = True, True, 0.0
    for _ in range(iters):
        replayed.run_layout(1)
        sample = eager_steps(eager, 1)[0]
        samples_equal &= bool(np.array_equal(
            replayed._graph_sample.cpu().numpy(), sample))
        a, b = replayed.positions, eager.positions
        positions_equal &= bool(np.array_equal(a, b))
        err = max(err, float(np.abs(a - b).max()))
    emit("graph_vs_eager", graph=label, n=replayed.n, E=replayed.n_edges,
         strategy=replayed._strategy, captured=replayed._graph is not None,
         iters=iters, samples_bit_equal=samples_equal,
         positions_bit_equal=positions_equal, max_abs_err=err)
    if replayed._graph is None or eager._graph is not None:
        raise AssertionError(f"{label}: the replayed engine must capture, "
                             "the eager one not")
    if not (samples_equal and positions_equal):
        raise AssertionError(f"{label}: replay differs from the eager loop")


def phase_sharded_graph_vs_eager(grt, label, adj, knn_comm, ref_order="row",
                                  mesh=None, iters=5):
    """Phase 20: ShardedGraphEmbedder on ``mesh`` (the one-rank NCCL mesh
    by default) with ``knn_comm`` and ``ref_order``: after one iteration
    each, ``iters`` iterations of run_layout (graph replay: the sample and
    the sharded step with every collective, captured once) against as many
    of the eager loop from the same generator state and start, both on the
    card, with their own sums: samples and positions bit-equal every
    iteration. Returns the row it prints."""
    kw = dict(n_components=3, seed=0, verbose=False, init="random",
              knn_comm=knn_comm, ref_order=ref_order, **FORCE_PARAMS)
    if mesh is None:
        mesh = grt.default_mesh()
    replayed = grt.ShardedGraphEmbedder(adj, mesh=mesh, **kw)
    eager = grt.ShardedGraphEmbedder(adj, mesh=mesh, **kw)
    replayed.run_layout(1)  # the eager first iteration, then the capture
    eager_steps(eager, 1)
    samples_equal, positions_equal, err = True, True, 0.0
    for _ in range(iters):
        replayed.run_layout(1)
        sample = eager_steps(eager, 1)[0]
        samples_equal &= bool(np.array_equal(
            replayed._graph_sample.cpu().numpy(), sample))
        a, b = replayed.positions, eager.positions
        positions_equal &= bool(np.array_equal(a, b))
        err = max(err, float(np.abs(a - b).max()))
    row = dict(graph=label, knn_comm=knn_comm, ref_order=ref_order,
               ranks=mesh.world_size, n=replayed.n, E=replayed.n_edges,
               table=replayed.table_kind,
               fused_refs=replayed._fused_refs_active,
               captured=replayed._graph is not None, iters=iters,
               samples_bit_equal=samples_equal,
               positions_bit_equal=positions_equal, max_abs_err=err)
    emit("sharded_graph_vs_eager", **row)
    if replayed._graph is None or eager._graph is not None:
        raise AssertionError(f"{label} {knn_comm}: the replayed engine must "
                             "capture, the eager one not")
    if not (samples_equal and positions_equal):
        raise AssertionError(f"{label} {knn_comm} {ref_order}: replay "
                             "differs from the eager loop")
    return row


def step_knn_inputs(emb, sampled):
    """The (queries, refs) that the engine's kNN takes for ``sampled`` at
    its current positions (row-order tables)."""
    from graphem_rapids_torch.ops import forces

    pos, ops = emb._positions, emb._ops
    if not emb._fused_refs_active:
        e = ops["edges"]
        mid = (pos[e[:, 0]] + pos[e[:, 1]]) / 2.0
        return mid[sampled.long()], mid
    refs = forces.midpoint_refs_binned(
        pos, [pos[t] for t in ops["tables"]], ops["buckets"],
        ops["ref_valid"], ops["overflow_lt"])
    return refs[ops["edge_ref"][sampled.long()]], refs


def phase_approx(grt, bf, kp, label, adj, init, warmup):
    """Phase 17: n_neighbors=48 (k+1 = 49 > the bin fold's MAX_K), so the
    engine resolves 'approx'; run_layout(50) under replay with no K1 or
    K2 launch, then one iteration's queries against knn_exact."""
    # the ops package binds the name knn to the function, as JAX's does
    tk = importlib.import_module("graphem_rapids_torch.ops.knn")
    params = dict(FORCE_PARAMS, n_neighbors=48)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emb = grt.GraphEmbedderTorch(adj, n_components=3, seed=0, verbose=False,
                                 init=init, **params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    refs = (int(len(emb._nb["ref_edge"])) if emb._fused_refs_active
            else emb.n_edges)
    budget = tk.oneshot_budget_bytes(emb.device)
    emit("approx_setup", graph=label, n=emb.n, E=emb.n_edges,
         table=emb.table_kind, strategy=emb._strategy,
         fused_refs=emb._fused_refs_active, refs=refs,
         oneshot=emb.sample_size * refs * 4 <= budget,
         oneshot_budget_bytes=budget, init=init, init_s=init_s)
    if emb._strategy != "approx":
        raise AssertionError(f"{label}: n_neighbors=48 must resolve 'approx'"
                             f", got {emb._strategy}")
    # the peak from the warm-up on: a replay allocates nothing, so the
    # eager first iteration and the capture hold the one-shot pass's peak
    torch.cuda.reset_peak_memory_stats()
    emb.run_layout(warmup, block_size=warmup)
    bf.knn_binfold.launches = kp.knn_pallas.launches = 0
    with segment_launches(f"{label} approx", ITERS) as seg_count:
        t0 = time.perf_counter()
        pos = emb.run_layout(ITERS, block_size=10)
        dt = time.perf_counter() - t0
    k1, k2 = bf.knn_binfold.launches, kp.knn_pallas.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    # one iteration's queries: the approx tier against knn_exact; a
    # neighbour counts as recalled when its distance is within the exact
    # k-th distance (ties among equal distances cannot lose recall)
    q, r = step_knn_inputs(emb, emb._sample())
    k = emb._k_eff
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, av = tk.knn(q, r, k, strategy="approx", chunk_size=emb.batch_size,
                   compute_dtype=emb.knn_compute_dtype)
    torch.cuda.synchronize()
    # the one-shot pass's peak over its (S, E_pad) float32 matrix: what
    # ONESHOT_PEAK_FACTOR stands for
    e_pad = -(-r.shape[0] // tk.ONESHOT_ROW_ALIGN) * tk.ONESHOT_ROW_ALIGN
    factor = ((torch.cuda.max_memory_allocated() - base)
              / (q.shape[0] * e_pad * 4))
    _, ev = tk.knn_exact(q, r, k)
    recall = float((av <= ev[:, -1:]).float().mean())
    std = pos.std(axis=0, ddof=1)
    emit("approx_run", graph=label, iters=ITERS, seconds=dt,
         ms_per_iter=dt / ITERS * 1e3, edges_per_s=emb.n_edges * ITERS / dt,
         peak_mem_gib=peak, reserved_gib=reserved,
         oneshot_peak_factor=factor,
         binfold_launches=k1, pallas_launches=k2,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         k=k,
         recall_vs_exact=recall,
         distances_equal_exact=bool(torch.equal(av, ev)),
         finite=bool(np.isfinite(pos).all()), std=std.tolist())
    if (k1, k2) != (0, 0):
        raise AssertionError(f"{label}: approx launched K1 {k1} / K2 {k2} "
                             "times")
    record_step(emb, f"{label} approx")
    if recall != 1.0:
        raise AssertionError(f"{label}: approx recall {recall} against "
                             "knn_exact")
    if pos.shape != (emb.n, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite")
    if not np.allclose(std, 1.0, atol=1e-3):
        raise AssertionError(f"{label}: per-axis std {std} is not ~1")


def phase_kernel_k3(rb, bf, fp32_instr_per_s, build_report):
    """Phase 10: K3 against its plain version on the card."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k = FORCE_PARAMS["n_neighbors"] + 1
    refs_1m = 5_699_741  # the 1M graph's fused refs

    def refs_of(E, d):
        r = torch.randn(E, d, generator=gen)
        r[torch.randperm(E, generator=gen)[:E // 40]] = 1e30
        return r.cuda()

    def periodic(E, d, T, G):
        """Refs repeating every G*T positions: a bin sees the same value in
        every super-tile, so every piece boundary of the plan cuts ties."""
        return torch.randn(G * T, d, generator=gen).cuda().repeat(
            -(-E // (G * T)), 1)[:E].contiguous()

    def split(r, ndev):
        """ndev equal tiles, the last padded with 1e30 rows."""
        E_loc = -(-r.shape[0] // ndev)
        pad = torch.full((E_loc * ndev - r.shape[0], r.shape[1]), 1e30,
                         device=r.device)
        return list(torch.cat([r, pad]).chunk(ndev))

    def plan(S, d, G, n_super):
        """The kernel's fold plan for a hop: units, blocks, pieces."""
        qb, _, units, n_blocks = bf.fold_plan(
            S, G, n_super, n_sm, d,
            rb._blocks_per_sm(torch.device("cuda", 0), d))
        pieces = sum(1 for _, _, s0, s1 in bf.fold_runs(units, n_blocks,
                                                        n_super)
                     if (s0, s1) != (0, n_super))
        return dict(qb=qb, units=units, blocks=n_blocks, pieces=pieces)

    worst = 0.0

    def plain(qs, tile, carry, offset, T, G, n_super, rows=64):
        """ring_fold_reference on ``rows`` queries at a time: the same bins
        (the fold is row by row) in a fraction of the memory."""
        parts = [rb.ring_fold_reference(
            qs[i:i + rows], tile, None if carry is None else
            (carry[0][i:i + rows], carry[1][i:i + rows]), offset, T, G,
            n_super) for i in range(0, qs.shape[0], rows)]
        return (torch.cat([v for v, _ in parts]),
                torch.cat([ix for _, ix in parts]))

    def check(name, qs, tile, carry, offset, T, G, n_super, in_place=False,
              **fields):
        """One hop by the kernel (in place on a copy of the carry, or into
        new bins) against the plain version: bins and ids bit-equal."""
        nonlocal worst
        out = None
        if in_place:
            out = (carry[0].clone(), carry[1].clone())
        kv, ki = rb.ring_fold_cuda(qs, tile, out if in_place else carry,
                                   offset, T, G, n_super, out=out)
        torch.cuda.synchronize()
        pv, pi = plain(qs, tile, carry, offset, T, G, n_super)
        equal = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
        err = float((kv - pv).abs().max())
        worst = max(worst, err)
        emit("kernel_check", kernel="ring_binfold", case=name,
             S_loc=qs.shape[0], E_loc=tile.shape[0], d=qs.shape[1], T=T, G=G,
             n_super=n_super, offset=offset, carry=carry is not None,
             in_place=in_place, **fields,
             **plan(qs.shape[0], qs.shape[1], G, n_super),
             bit_equal=equal, max_abs_err=err)
        if not equal:
            raise AssertionError(f"ring kernel disagrees with plain: {name}")
        return kv, ki

    def hop(name, q, tiles, rank, h, in_place=False):
        """Rank ``rank``'s hop ``h``; its carry is folded by the plain
        version over the ranks before it on the same shard. Returns the
        kernel's bins, the carry and R_pad."""
        ndev = len(tiles)
        T, G, n_super, R_pad, S_pad, S_loc, _ = rb._geometry(
            tiles[0].shape[0], q.shape[0], ndev, k, 0.95)
        s = (rank - h) % ndev
        qs = rb._padded_queries(q, S_pad)[s * S_loc:(s + 1) * S_loc]
        carry = None
        for j in range(h):
            r = (s + j) % ndev
            carry = plain(qs, tiles[r], carry, r * R_pad, T, G, n_super)
        kv, ki = check(name, qs, tiles[rank], carry, rank * R_pad, T, G,
                       n_super, in_place=in_place, ranks=ndev, rank=rank,
                       hop=h, shard=s, S=q.shape[0], R_pad=R_pad)
        return kv, ki, carry, R_pad

    q512 = torch.randn(512, 3, generator=gen).cuda()
    hop("100k_1rank_512q", q512, [refs_of(800_000, 3)], 0, 0)
    r1m = refs_of(refs_1m, 3)
    hop("1m_1rank_512q", q512, [r1m], 0, 0)  # the shape timed below
    t4 = split(r1m, 4)
    hop("1m_4ranks_hop0", q512, t4, 1, 0)
    hop("1m_4ranks_hop1", q512, t4, 2, 1)
    hop("1m_4ranks_hop3", q512, t4, 0, 3, in_place=True)
    t8 = split(r1m, 8)
    hop("1m_8ranks_hop0", q512, t8, 3, 0)
    hop("1m_8ranks_hop5", q512, t8, 6, 5)
    del t8
    q64 = torch.randn(64, 3, generator=gen).cuda()
    hop("1m_1rank_64q", q64, [r1m], 0, 0)
    for d in (2, 4):
        q500 = torch.randn(500, d, generator=gen).cuda()
        tr = split(refs_of(4 * 9001 - 5, d), 4)
        hop(f"ragged_s500_d{d}_hop0", q500, tr, 3, 0)  # shard 3: pad rows
        hop(f"ragged_s500_d{d}_hop2", q500, tr, 1, 2)
    a = refs_of(50_000, 3)
    qd = torch.randn(256, 3, generator=gen).cuda()
    kv, ki, _, R_pad = hop("duplicate_tiles_hop1", qd, [a, a.clone()], 1, 1)
    if bool(((ki >= R_pad) & (kv < 3.0e38)).any()):
        raise AssertionError("ring kernel: a tie did not keep the carry")
    # fewer units than resident blocks; d=1 and d=8 (8 queries a thread)
    hop("fewer_units_than_blocks_d2", torch.randn(7, 2, generator=gen).cuda(),
        split(refs_of(2 * 9001, 2), 2), 1, 1)
    hop("d1_hop1", torch.randn(512, 1, generator=gen).cuda(),
        split(refs_of(2 * 300_001, 1), 2), 0, 1, in_place=True)
    hop("d8_hop1", torch.randn(200, 8, generator=gen).cuda(),
        split(refs_of(2 * 100_000, 8), 2), 1, 1)
    # ties across every piece boundary and against the carry: every rank
    # holds the same periodic tile, so the carry (the first rank folded)
    # must win every bin, with the p of its first super-tile
    for name, q, E_loc, ndev, rank, h in (
            ("ties_pieces_and_carry_1m_64q", torch.randn(
                128, 3, generator=gen).cuda(), refs_1m, 2, 1, 1),
            ("ties_pieces_and_carry_4ranks_hop3", q512, 1_424_936, 4, 2, 3)):
        T, G, _, _, _, _, _ = rb._geometry(E_loc, q.shape[0], ndev, k, 0.95)
        tile = periodic(E_loc, 3, T, G)
        kv, ki, carry, R_pad = hop(name, q, [tile] * ndev, rank, h,
                                   in_place=True)
        first = (rank - h) % ndev * R_pad  # the shard's first rank's ids
        kept = kv < 3.0e38
        if not (torch.equal(kv, carry[0]) and torch.equal(ki, carry[1])
                and bool(((ki[kept] >= first)
                          & (ki[kept] < first + G * T)).all())):
            raise AssertionError(f"ring kernel: {name} did not keep the "
                                 "carry's first super-tile")
        del tile

    T, G, n_super, R_pad, _, S_loc, _ = rb._geometry(refs_1m, 512, 1, k, 0.95)
    # in place on a carry at the one-rank 1M shape (S_loc=512)
    carry = plain(q512, refs_of(refs_1m, 3), None, 0, T, G, n_super)
    check("in_place_1m_512q", q512, r1m, carry, R_pad, T, G, n_super,
          in_place=True, R_pad=R_pad)

    for name, q, tiles in (("1m_4ranks", q512, t4),
                           ("s500_8ranks", torch.randn(
                               500, 3, generator=gen).cuda(),
                            split(refs_of(400_000, 3), 8))):
        kv, ki, _ = rb.ring_binfold_topk_virtual(q, tiles, k)
        torch.cuda.synchronize()
        pv, pi, _ = rb.ring_binfold_topk_virtual(
            q, tiles, k, fold=rb.ring_fold_reference)
        sets = bool(torch.equal(torch.sort(ki, dim=1).values,
                                torch.sort(pi, dim=1).values))
        equal = bool(torch.equal(kv, pv)) and sets
        emit("kernel_check", kernel="ring_binfold", case="virtual_ring_" + name,
             ranks=len(tiles), S=q.shape[0], k=k, distances_equal=bool(
                 torch.equal(kv, pv)), sets_equal=sets)
        if not equal:
            raise AssertionError(f"virtual ring disagrees with plain: {name}")

    ptx = ptxas_lines(build_report, "ring_binfold", "ring_fold_kernelILi3E")
    emit("kernel_ptxas", name="ring_binfold", d=3, ptxas=ptx)
    if not ptx or spills(ptx):
        raise AssertionError(f"ring kernel at d=3: {ptx}")

    # times: the one-rank 1M shape, 64 queries against the same refs, and
    # the four-card tile with a carry, merged in place as the ring does
    T4, G4, n_super4, R_pad4, _, _, _ = rb._geometry(t4[3].shape[0], 512, 4,
                                                     k, 0.95)
    q128 = q512[:128]
    carry4 = plain(q128, t4[2], None, 2 * R_pad4, T4, G4, n_super4)
    shapes = (
        ("1m_1rank_512q", q512, r1m, None, 0, T, G, n_super),
        ("1m_1rank_64q", q64, r1m, None, 0, T, G, n_super),
        ("4card_tile_carry", q128, t4[3], carry4, 3 * R_pad4, T4, G4,
         n_super4),
    )
    out = {"max_abs_err": worst}
    for label, qs, tile, carry, offset, T_, G_, ns_ in shapes:
        S_, d = qs.shape
        scratch = rb.ring_fold_scratch(S_, d, G_, ns_, qs.device)

        def fold(scratch=scratch):
            return rb.ring_fold_cuda(qs, tile, carry, offset, T_, G_, ns_,
                                     out=carry, scratch=scratch)

        ms = cuda_ms(fold)
        b2b = back_to_back_ms(fold)
        # a hop that allocates its own scratch, as a lone ring_fold does
        ms_own = cuda_ms(lambda: fold(None))
        b2b_own = back_to_back_ms(lambda: fold(None))
        plain_ms = cuda_ms(
            lambda: plain(qs, tile, carry, offset, T_, G_, ns_), reps=3,
            warmup=1)
        R = ns_ * G_ * T_
        # K1's fold per pair (3d + 2, as in phase 3); the carry merge is per
        # bin. Bytes: queries, refs, bins out, and the carry in
        ops = (3 * d + 2) * S_ * R
        nbytes = (4 * (S_ * d + tile.shape[0] * d)
                  + 8 * S_ * G_ * 128 * (1 if carry is None else 2))
        ops_ms = ops / fp32_instr_per_s * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        emit("kernel_time", name="ring_binfold", shape=label, S_loc=S_,
             E_loc=tile.shape[0], R_pad=R, d=d, G=G_, n_super=ns_,
             offset=offset, carry=carry is not None, **plan(S_, d, G_, ns_),
             kernel_ms=ms, back_to_back_ms=b2b, kernel_ms_own_scratch=ms_own,
             back_to_back_ms_own_scratch=b2b_own, plain_ms=plain_ms,
             ops=ops, bytes=nbytes,
             ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
             share_of_bound=bound / ms, share_of_bound_back_to_back=bound / b2b)
        if label == "1m_1rank_512q":
            out.update(plain_ms=plain_ms, bound_ms=bound,
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes", hop_ms=ms, hop_back_to_back_ms=b2b)
    del t4
    # the whole-ring entry (the sharded path's launch) at the one-rank 1M
    # shape, a ring of one hop, in turns with the per-hop entry
    from graphem_rapids_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 0, q512.device)
    region = rb.ring_region(mesh, 512, 3, G, n_super)
    ring_out = (torch.empty((512, G * 128), device=q512.device),
                torch.empty((512, G * 128), dtype=torch.int32,
                            device=q512.device))

    def ring():
        return rb.ring_run_cuda(q512, r1m, region, ring_out, 0, 1, (0, 1), T,
                                G, n_super, R_pad)

    ring()
    want = plain(q512, r1m, None, 0, T, G, n_super)
    equal = bool(torch.equal(ring_out[0], want[0])
                 and torch.equal(ring_out[1], want[1]))
    scratch = rb.ring_fold_scratch(512, 3, G, n_super, q512.device)

    def hop1():
        return rb.ring_fold_cuda(q512, r1m, None, 0, T, G, n_super,
                                 scratch=scratch)

    turns = {"ring": [], "hop": []}
    for name in ("ring", "hop", "hop", "ring"):
        turns[name].append(back_to_back_ms(ring if name == "ring" else hop1))
    ring_ms = cuda_ms(ring)
    emit("kernel_time", name="ring_binfold", entry="whole_ring",
         shape="1m_1rank_512q", S_loc=512, R_pad=R_pad, blocks=region.made_for[
             5], bit_equal=equal, kernel_ms=ring_ms,
         back_to_back_ms=turns["ring"], hop_back_to_back_ms=turns["hop"],
         bound_ms=out["bound_ms"])
    if not equal:
        raise AssertionError("whole-ring kernel (one rank) disagrees with "
                             "the plain hop")
    out.update(ms=ring_ms, back_to_back_ms=min(turns["ring"]))
    return out


def phase_transfer(rb):
    """Phase 19: K3's whole-ring launch through its store-and-flag transfer
    path on one card. Over 2, 4 and 8 virtual ranks (the 1M graph's refs
    split into tiles, 512 queries), and over 3, 4 and 8 ranks of 70,000
    refs with 200 queries (two super-tiles a segment, so most runs are
    pieces and blocks run hops apart), each rank's region mapped as its
    neighbours' (ring_binfold_topk_transfer): (a) one hop per launch per
    rank in ring order, every wait met at launch; (b) every rank's whole
    ring at once, one stream each, on 1/ndev of the resident blocks, all
    resident together. Three ring calls each on the same regions (the later
    ones run on the epochs and flags the first left). Every call's distances
    and ids must be bit-equal to the per-hop ring
    (ring_binfold_topk_virtual, the kernel per hop, which phase 10 holds
    against the plain version)."""
    gen = torch.Generator(device="cpu").manual_seed(4)
    k = FORCE_PARAMS["n_neighbors"] + 1
    refs = torch.randn(5_699_741, 3, generator=gen)
    refs[torch.randperm(refs.shape[0], generator=gen)[:refs.shape[0] // 40]] \
        = 1e30
    refs = refs.cuda()
    q512 = torch.randn(512, 3, generator=gen).cuda()
    q200 = torch.randn(200, 3, generator=gen).cuda()
    out = []
    for ndev, q, E_loc in ((2, q512, None), (4, q512, None), (8, q512, None),
                           (3, q200, 70_000), (4, q200, 70_000),
                           (8, q200, 70_000)):
        if E_loc is None:
            E_loc = -(-refs.shape[0] // ndev)
            pad = torch.full((E_loc * ndev - refs.shape[0], 3), 1e30,
                             device="cuda")
            tiles = list(torch.cat([refs, pad]).chunk(ndev))
        else:
            tiles = list(refs[:ndev * E_loc].chunk(ndev))
        before = rb.ring_fold.launches
        want_v, want_i, R_pad = rb.ring_binfold_topk_virtual(q, tiles, k)
        hop_launches = rb.ring_fold.launches - before
        for concurrent in (False, True):
            before = rb.ring_fold.launches
            t0 = time.perf_counter()
            results, R2 = rb.ring_binfold_topk_transfer(
                q, tiles, k, concurrent=concurrent, calls=3)
            seconds = time.perf_counter() - t0
            launches = rb.ring_fold.launches - before
            equal = all(bool(torch.equal(v, want_v) and torch.equal(
                torch.sort(i, dim=1).values, torch.sort(want_i, dim=1).values))
                for v, i in results) and R2 == R_pad
            err = max(float((v - want_v).abs().max()) for v, _ in results)
            T, G, n_super, _, _, S_loc, _ = rb._geometry(
                E_loc, q.shape[0], ndev, k, 0.95)
            row = dict(ranks=ndev, mode="concurrent" if concurrent
                       else "hop_by_hop", calls=3, S=q.shape[0],
                       S_loc=S_loc, E_loc=E_loc,
                       G=G, n_super=n_super, blocks=rb.ring_run_grid(
                           S_loc, 3, G, n_super, q.device,
                           share=ndev if concurrent else 1),
                       launches=launches, per_hop_launches=hop_launches,
                       seconds=seconds, bit_equal=equal, max_abs_err=err)
            emit("ring_transfer", **row)
            out.append(row)
            if not equal:
                raise AssertionError(f"ring transfer ({row['mode']}, {ndev} "
                                     "ranks) differs from the per-hop ring")
        del tiles
    return out


def phase_sharded(grt, bf, rb, label, adj, init, warmup, profile, log,
                  knn_comm="ring_pallas", mesh=None, start_ref=None,
                  ref_order="row"):
    """Phase 11: ShardedGraphEmbedder on the one-rank NCCL mesh, or on
    ``mesh`` (a one-rank mesh without a process group, for comparison).
    ``start_ref``: the single-card Chebyshev start the engine's own must
    equal modulo column signs."""
    import torch.distributed as dist

    nccl = mesh is None
    if nccl:
        mesh = grt.default_mesh()
    t0 = time.perf_counter()
    emb = grt.ShardedGraphEmbedder(adj, mesh=mesh, knn_comm=knn_comm,
                                   n_components=3, seed=0, verbose=False,
                                   init=init, ref_order=ref_order,
                                   **FORCE_PARAMS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    start = {}
    if start_ref is not None:
        pos0 = emb.positions
        start = dict(start_max_err=max_err_modulo_signs(pos0, start_ref),
                     start_bit_equal=bool(np.array_equal(pos0, start_ref)),
                     **chebyshev_fields(log, label, 1))
    log.take(label)
    refs = int(len(emb._nb["ref_edge"])) if emb._fused_refs_active \
        else emb.n_edges
    k = FORCE_PARAMS["n_neighbors"] + 1
    T, G, n_super, R_pad, _, S_loc, _ = rb._geometry(
        refs, emb.sample_size, mesh.world_size, k, emb.knn_recall_target)
    backend = dist.get_backend(mesh.group) if mesh.group is not None \
        else "none"
    emit("sharded_setup", graph=label, knn_comm=knn_comm,
         ref_order=ref_order, ranks=mesh.world_size, backend=backend,
         n=emb.n, E=emb.n_edges, table=emb.table_kind,
         fused_refs=emb._fused_refs_active, refs=refs, R_pad=R_pad, G=G,
         n_super=n_super, S_loc=S_loc, init=init, init_s=init_s, **start)
    if start and not start["start_max_err"] < 1e-4:
        raise AssertionError(f"{label}: the sharded Chebyshev start is "
                             f"{start['start_max_err']} from the single-card "
                             "one (modulo signs; atol 1e-4)")
    if (nccl and backend != "nccl") or emb.device.type != "cuda":
        raise AssertionError(f"{label}: the sharded path must run on the "
                             "card's NCCL group")
    if not emb._fused_refs_active:
        raise AssertionError(f"{label}: a CUDA mesh fuses the kNN refs")
    emb.run_layout(warmup, block_size=warmup)

    rb.ring_fold.launches = 0
    bf.knn_binfold.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with segment_launches(f"{label} sharded {knn_comm}", ITERS) as seg_count:
        t0 = time.perf_counter()
        pos = emb.run_layout(ITERS, block_size=10)
        dt = time.perf_counter() - t0
    ring, k1 = rb.ring_fold.launches, bf.knn_binfold.launches
    std = pos.std(axis=0, ddof=1)
    emit("sharded_run", graph=label, knn_comm=knn_comm, ref_order=ref_order,
         backend=backend, replayed=emb._graph is not None, iters=ITERS,
         seconds=dt, ms_per_iter=dt / ITERS * 1e3,
         edges_per_s=emb.n_edges * ITERS / dt,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         ring_binfold_launches=ring, binfold_launches=k1,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         finite=bool(np.isfinite(pos).all()), std=std.tolist())
    # one K3 launch per iteration runs every hop of the ring
    want = (ITERS, 0) if knn_comm == "ring_pallas" else (0, ITERS)
    if (ring, k1) != want:
        raise AssertionError(f"{label} {knn_comm}: {ring} K3 and {k1} K1 "
                             f"launches in {ITERS} iterations, want {want}")
    if pos.shape != (emb.n, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite")
    if not np.allclose(std, 1.0, atol=1e-3):
        raise AssertionError(f"{label}: per-axis std {std} is not ~1")
    if emb._graph is None:
        raise AssertionError(f"{label}: the sharded step must replay a graph")
    record_step(emb, f"{label} sharded {knn_comm} {ref_order}")
    if profile:
        profile_steps(emb, f"{label}_sharded_{knn_comm}_{ref_order}",
                      dt / ITERS * 1e3)
    return ring, k1


def phase_sharded_vs_single(grt):
    """Phase 12: the one-rank 'ring_pallas' step against the single-card
    'binfold' engine, both on the card, with the engines' own sums."""
    adj = regular_union_graph(2000, cycles=3, seed=1)
    kw = dict(n_components=3, seed=0, verbose=False, init="scipy",
              **FORCE_PARAMS)
    single = grt.GraphEmbedderTorch(adj, device="cuda", knn_strategy="binfold",
                                    **kw)
    sharded = grt.ShardedGraphEmbedder(adj, mesh=grt.default_mesh(),
                                       knn_comm="ring_pallas", **kw)
    if not (single._fused_refs_active and sharded._fused_refs_active):
        raise AssertionError("sharded vs single: both must fuse the refs")
    rng = np.random.default_rng(6)
    for _ in range(5):
        s = rng.permutation(single.n_edges)[:single.sample_size]
        single.update_positions(sample_indices=s)
        sharded.update_positions(sample_indices=s)
    a, b = sharded.positions, single.positions
    err = float(np.abs(a - b).max())
    ok = bool(np.allclose(a, b, rtol=1e-4, atol=1e-5))
    emit("sharded_vs_single", n=single.n, E=single.n_edges, steps=5,
         max_abs_err=err, bit_equal=bool(np.array_equal(a, b)), rtol=1e-4,
         atol=1e-5, allclose=ok)
    if not ok:
        raise AssertionError("one-rank ring_pallas disagrees with binfold")


def phase_spectral(log, graphs):
    """Phase 14: the Chebyshev tier on the card against the CPU and host
    eigsh, and LOBPCG on the card; returns {label: the card's start}.

    ``graphs``: (label, adjacency, check), check one of 'eigsh' (the card
    within eigsh's 3 lowest nontrivial eigenvectors, and LOBPCG), 'span'
    (within eigsh's 8 lowest) or 'block_plan' (the SpMV takes the hub
    block-fold plan: eigsh as 'eigsh', and the card's columns equal the
    CPU's modulo sign at SPECTRAL_BLOCK_ATOL)."""
    import scipy.sparse.linalg as spla

    from graphem_rapids_torch.ops import laplacian as lap

    starts = {}
    for label, adj, check in graphs:
        L = lap._normalized_laplacian(adj)
        t0 = time.perf_counter()
        # eigenpairs with the trivial one: 4, or 9 for the span check
        lam, V = spla.eigsh(L, 9 if check == "span" else 4, which="SM",
                            v0=np.random.default_rng(0).standard_normal(
                                adj.shape[0]))
        eigsh_s = time.perf_counter() - t0
        runs = []
        for _ in range(2):  # cold, then warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            card = lap._spectral_chebyshev(adj, 3, seed=0, device="cuda")
            runs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        cheb = chebyshev_fields(log, label, 2)
        t0 = time.perf_counter()
        cpu = lap._spectral_chebyshev(adj, 3, seed=0, device="cpu")
        cpu_s = time.perf_counter() - t0
        log.take(label)
        fields = dict(
            graph=label, n=adj.shape[0], check=check,
            spmv_overflow=cheb["spmv_overflow"],
            spmv_overflow_pairs=cheb["spmv_overflow_pairs"],
            seconds_cold=runs[0], seconds=runs[1], peak_mem_gib=peak,
            cpu_seconds=cpu_s, eigsh_seconds=eigsh_s,
            eigsh_eigenvalues=lam.tolist(), ritz=cheb["ritz"],
            align_card_cpu=alignment(card, cpu),
            max_err_card_cpu=max_err_modulo_signs(card, cpu),
            align_card_eigsh=alignment(card, V[:, 1:4]),
            finite=bool(np.isfinite(card).all()))
        if check == "span":
            fields["align_card_in_eigsh_8"] = alignment(card, V[:, 1:9])
        elif check == "eigsh":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lob = lap._spectral_lobpcg(L, 3, seed=0, device="cuda")
            fields.update(lobpcg_seconds=time.perf_counter() - t0,
                          lobpcg_finite=bool(np.isfinite(lob).all()),
                          lobpcg_align_eigsh=alignment(lob, V[:, 1:4]))
        emit("spectral", **fields)
        if not fields["finite"] or fields["align_card_cpu"] < 0.999:
            raise AssertionError(f"{label}: the card's Chebyshev start is "
                                 "not the CPU's")
        gate = fields["align_card_in_eigsh_8" if check == "span"
                      else "align_card_eigsh"]
        if gate < 0.95 or not fields.get("lobpcg_finite", True):
            raise AssertionError(f"{label}: the card's spectral start missed "
                                 f"eigsh ({gate} < 0.95) or LOBPCG is not "
                                 "finite")
        if check == "block_plan" and (
                fields["spmv_overflow"] != "block"
                or fields["max_err_card_cpu"] > SPECTRAL_BLOCK_ATOL):
            raise AssertionError(
                f"{label}: overflow {fields['spmv_overflow']} (block "
                f"wanted), card against CPU {fields['max_err_card_cpu']} "
                f"modulo signs (<= {SPECTRAL_BLOCK_ATOL} wanted)")
        starts[label] = card
    return starts


def phase_toolkit(grt, bf, log, checked):
    """Phase 15: run_benchmark on the card (K1, at shapes phase 3
    ``checked``), and a vendored dataset embedded; returns K1's
    launches."""
    from scipy.stats import spearmanr

    params = TOOLKIT_PARAMS
    bf.knn_binfold.launches = 0
    with k1_shapes(bf, checked, "toolkit") as shapes, \
            segment_launches("toolkit", 40) as seg_count:
        res = grt.run_benchmark(grt.generate_ba, params,
                                compute_centrality=False, seed=0)
    launches = bf.knn_binfold.launches
    deg = grt.compute_vertex_degrees(grt.generate_ba(**params))
    rho = float(spearmanr(res["radii"], deg).statistic)
    finite = bool(np.isfinite(res["positions"]).all())
    saved = os.environ.get("GRAPHEM_DATA_DIR")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["GRAPHEM_DATA_DIR"] = tmp
            adj = grt.load_dataset_as_adjacency("local-karate")
    finally:
        if saved is None:
            os.environ.pop("GRAPHEM_DATA_DIR", None)
        else:
            os.environ["GRAPHEM_DATA_DIR"] = saved
    emb = grt.create_graphem(adj, n_components=2, seed=0, verbose=False)
    pos = emb.run_layout(30)
    rho_karate = float(spearmanr(np.linalg.norm(pos, axis=1),
                                 grt.compute_vertex_degrees(adj)).statistic)
    log.take("toolkit")
    emit("toolkit", benchmark="run_benchmark(generate_ba)", **params,
         m_edges=res["m"], layout_time=res["layout_time"],
         edges_per_second=res["edges_per_second"], binfold_launches=launches,
         segment_sum_launches=seg_count["launches"],
         segment_cluster_launches=seg_count["cluster_launches"],
         binfold_shapes=sorted(shapes),
         spearman_radius_degree=rho, finite=finite,
         karate_n=adj.shape[0], karate_device=str(emb.device),
         karate_spearman_radius_degree=rho_karate)
    if launches != 40 or not finite or rho < 0.5:
        raise AssertionError(f"toolkit: {launches} K1 launches in 40 "
                             f"iterations, Spearman {rho} (>= 0.5 wanted)")
    if emb.device.type != "cuda" or not np.isfinite(pos).all() \
            or rho_karate <= 0.4:
        raise AssertionError(f"karate: Spearman {rho_karate} (> 0.4 wanted)")
    record_step(emb, "karate")
    return launches


def _user_edges(adj):
    rows, cols = adj.nonzero()
    mask = rows < cols
    return np.column_stack([rows[mask], cols[mask]]).astype(np.int64)


def rank_worker(rank, world, tmp, backend, profile=False):
    """One rank of phase 13; writes its checks to ``tmp/rank<r>.json``."""
    import torch.distributed as dist

    import graphem_rapids_torch as grt

    if backend == "gloo":
        torch.set_num_threads(1)
    grt.distributed_init(backend=backend, init_method=f"file://{tmp}/store",
                         world_size=world, rank=rank)
    try:
        return _rank_checks(grt, rank, world, tmp, profile)
    finally:
        dist.destroy_process_group()


def _rank_checks(grt, rank, world, tmp, profile):
    from graphem_rapids_torch.ops.forces import build_neighbor_table
    from graphem_rapids_torch.parallel import ring_binfold as rb
    from graphem_rapids_torch.parallel.sharded_step import (
        KNN_COMMS,
        REPLICA_GAP_LIMIT,
        build_sharded_step,
        pad_edges,
    )

    mesh = grt.make_mesh(world)
    dev = mesh.device
    adj = regular_union_graph(20_000, cycles=4, seed=2)
    k = FORCE_PARAMS["n_neighbors"]
    rng = np.random.default_rng(9)

    on_card = dev.type == "cuda"
    # the ring's neighbours can store into each other's cards (raises at
    # construction otherwise); positions stay bit-equal across ranks
    where = rb.check_ring_peers(mesh)
    emb = grt.ShardedGraphEmbedder(adj, mesh=mesh, knn_comm="ring_pallas",
                                   n_components=3, seed=0, verbose=False,
                                   init="random", **FORCE_PARAMS)
    rb.ring_fold.launches = 0
    for _ in range(5):
        emb.update_positions(
            sample_indices=rng.permutation(emb.n_edges)[:emb.sample_size])
    launches = rb.ring_fold.launches
    pos = torch.as_tensor(emb.positions, device=dev)
    every = mesh.all_gather(pos)
    ranks_equal = all(bool(torch.equal(every[r], pos)) for r in range(world))
    # generator-drawn samples: every rank draws the same one, and its own
    # update stays within rounding of rank 0's before the broadcast
    try:
        emb.run_layout(3, block_size=3)  # raises past REPLICA_GAP_LIMIT
        layout_error = None
    except RuntimeError as e:  # reported below; the ranks go on together
        layout_error = str(e)
    nxt = emb._sample()
    samples_equal = all(bool(torch.equal(x, nxt))
                        for x in mesh.all_gather(nxt))
    gap = emb.replica_gap

    # a rank started apart: under replay (on the cards) the gap is read at
    # the end of run_layout, which must raise on every rank but rank 0
    apart = grt.ShardedGraphEmbedder(adj, mesh=mesh, knn_comm="ring_pallas",
                                     n_components=3, seed=0, verbose=False,
                                     init="random", **FORCE_PARAMS)
    start = apart.positions
    apart.positions = start + 0.01 * rank * np.random.default_rng(
        rank).standard_normal(start.shape).astype(np.float32)
    try:
        apart.run_layout(3, block_size=3)
        apart_raised = False
    except RuntimeError:
        apart_raised = True
    apart_ok = apart_raised == (rank != 0) and (
        apart._graph is not None) == on_card

    # replay against the eager loop for every knn_comm and both ref orders
    replay_rows = []
    if on_card:
        for comm in KNN_COMMS:
            for order in ("row", "slot"):
                replay_rows.append(phase_sharded_graph_vs_eager(
                    grt, "regular_union_20k", adj, comm, order, mesh=mesh))
    replay_ok = all(r["positions_bit_equal"] and r["samples_bit_equal"]
                    for r in replay_rows)

    # neighbour sets of the sharded step against the virtual ring
    edges = _user_edges(adj)
    n, E = adj.shape[0], len(edges)
    nb = build_neighbor_table(edges, n)
    edges_p, valid = pad_edges(edges, world)
    ep = torch.as_tensor(edges_p, device=dev).long()
    vp = torch.as_tensor(valid, device=dev)
    start = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32),
                            device=dev)
    sampled = torch.as_tensor(rng.permutation(E)[:512], device=dev)
    _, _, ops, raw = build_sharded_step(
        mesh, n, E, n_components=3, k_attr=0.5, L_min=10.0, k_inter=0.1,
        n_neighbors=k, sample_size=512, nb=nb, knn_comm="ring_pallas",
        fused_refs=False, _debug_knn=True, return_raw=True)
    knn_idx, _ = raw(start, ep, vp, sampled, ops)
    mids = (start[ep[:, 0]] + start[ep[:, 1]]) / 2.0
    mids = torch.where(vp[:, None] > 0, mids, torch.full_like(mids, 1e30))
    E_loc = len(edges_p) // world
    tiles = list(mids.chunk(world))
    q = mids[sampled.long()]
    k_merge = min(k + 1, world * min(k + 1, E_loc))
    _, vidx, R_pad = rb.ring_binfold_topk_virtual(q, tiles, k_merge)
    vidx = vidx.long()
    owner = vidx // R_pad
    local = torch.clamp(vidx % R_pad, max=E_loc - 1)
    virtual = (local + owner * E_loc)[:, 1:]
    sets_equal = bool(torch.equal(torch.sort(knn_idx, dim=1).values,
                                  torch.sort(virtual, dim=1).values))
    # each rank's row-sharded Chebyshev start, before any broadcast,
    # against rank 0's and against its own single-card runner's
    from graphem_rapids_torch.ops.laplacian import _spectral_chebyshev

    cheb = _spectral_chebyshev(adj, 3, seed=0, mesh=mesh)
    cheb_all = mesh.all_gather(torch.as_tensor(cheb, device=dev)).cpu()
    cheb_vs_rank0 = max_err_modulo_signs(cheb, cheb_all[0].numpy())
    cheb_vs_single = max_err_modulo_signs(
        cheb, _spectral_chebyshev(adj, 3, seed=0, device=dev))
    res = {"rank": rank, "device": str(dev), "ranks_bit_equal": ranks_equal,
           "chebyshev_vs_rank0": cheb_vs_rank0,
           "chebyshev_vs_single_card": cheb_vs_single,
           "ring_binfold_launches": launches, "sets_equal": sets_equal,
           "samples_equal": samples_equal, "replica_gap": gap,
           "replica_gap_limit": REPLICA_GAP_LIMIT,
           "layout_error": layout_error, "ranks_where": where,
           "apart_raised": apart_raised, "apart_replayed":
               apart._graph is not None,
           "graph_vs_eager": [{k: r[k] for k in (
               "knn_comm", "ref_order", "table", "captured",
               "positions_bit_equal", "samples_bit_equal")}
               for r in replay_rows]}
    if on_card and profile:
        # the 1M graph across the cards under replay: ms per iteration on
        # the rank's own clock, and its trace
        adj1m = ring_chords_graph()
        for comm in ("ring_pallas", "all_gather"):
            emb = grt.ShardedGraphEmbedder(adj1m, mesh=mesh, knn_comm=comm,
                                           n_components=3, seed=0,
                                           verbose=False, init="random",
                                           **FORCE_PARAMS)
            emb.run_layout(3, block_size=3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emb.run_layout(20, block_size=10)
            ms = (time.perf_counter() - t0) / 20 * 1e3
            res[f"ring_chords_1m_{comm}_ms_per_iter"] = ms
            # how far the host runs ahead: 20 replays enqueued, then the
            # wait for the card
            t0 = time.perf_counter()
            emb._iterate(20)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            res[f"ring_chords_1m_{comm}_replay"] = {
                "enqueue_ms_per_iter": (t1 - t0) / 20 * 1e3,
                "wall_ms_per_iter": (t2 - t0) / 20 * 1e3}
            prof = profile_steps(emb, f"ring_chords_1m_{comm}_rank{rank}", ms)
            res[f"ring_chords_1m_{comm}_profile"] = {
                k: prof[k] for k in ("device_ms_per_iter",
                                     "device_busy_share", "kernels_per_iter",
                                     "host_launches_per_iter", "top")}
            del emb
        res["ring_kernel"] = ring_kernel_times(rb, mesh, world)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    # one K3 launch per rank per step; the CPU (a gloo rehearsal) has none
    want = 5 if on_card else 0
    ok = (ranks_equal and sets_equal and samples_equal and launches == want
          and gap <= REPLICA_GAP_LIMIT and layout_error is None
          and cheb_vs_rank0 < 1e-4 and cheb_vs_single < 1e-4 and apart_ok
          and replay_ok)
    return 0 if ok else 1


def ring_kernel_times(rb, mesh, world, reps=20):
    """K3 on the four-card 1M tile (S=512 queries, S_loc = 512 / world,
    1,424,936 refs a rank at four cards): the whole ring, every rank
    launching ``reps`` rings back to back between CUDA events on its own
    card (the kernels wait on each other), against ``world`` per-hop
    launches back to back on the same card (no transfer) and the bound of
    ``world`` hops' instructions."""
    gen = torch.Generator(device="cpu").manual_seed(5 + mesh.rank)
    E_loc = -(-5_699_741 // world)
    k = FORCE_PARAMS["n_neighbors"] + 1
    refs = torch.randn(E_loc, 3, generator=gen).cuda()
    q = torch.randn(512, 3, generator=torch.Generator(
        device="cpu").manual_seed(5)).cuda()
    T, G, n_super, R_pad, S_pad, S_loc, _ = rb._geometry(E_loc, 512, world,
                                                         k, 0.95)
    region = rb.ring_region(mesh, S_loc, 3, G, n_super)
    shape = (S_loc, G * 128)
    out = (torch.empty(shape, device=refs.device),
           torch.empty(shape, dtype=torch.int32, device=refs.device))
    qp = rb._padded_queries(q, S_pad)

    def ring():
        rb.ring_run_cuda(qp, refs, region, out, mesh.rank, world,
                         (0, world), T, G, n_super, R_pad)

    ring()
    mesh.all_reduce(torch.zeros(1, device=refs.device))
    torch.cuda.synchronize()
    ring_ms = back_to_back_ms(ring, reps=reps, warmup=0)
    scratch = rb.ring_fold_scratch(S_loc, 3, G, n_super, refs.device)
    carry = rb.ring_fold_cuda(qp[:S_loc], refs, None, 0, T, G, n_super,
                              scratch=scratch)
    hop_ms = back_to_back_ms(lambda: rb.ring_fold_cuda(
        qp[:S_loc], refs, carry, mesh.rank * R_pad, T, G, n_super, out=carry,
        scratch=scratch))
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bound_ms = world * (3 * 3 + 2) * S_loc * n_super * G * T / (
        n_sm * 128 * clock_mhz * 1e6) * 1e3
    return {"S_loc": S_loc, "E_loc": E_loc, "R_pad": R_pad, "hops": world,
            "blocks": region.made_for[5], "ring_ms": ring_ms,
            "hop_ms": hop_ms, "hops_ms": world * hop_ms,
            "bound_ms": bound_ms,
            "ring_over_hops": ring_ms / (world * hop_ms)}


def phase_multi_card(backend="nccl", world=None, profile=False):
    """Phase 13: several ranks, one process each (skipped on one card)."""
    if world is None:
        count = torch.cuda.device_count()
        if count < 2:
            emit("multi_card", skipped="1 card")
            return None
        world = min(count, 4)
    if backend == "nccl":
        # the ring's neighbours store into each other's cards: peer access
        # between every pair, and the host's topology
        count = torch.cuda.device_count()
        emit("multi_card_peers", peer_access=[
            [a == b or torch.cuda.can_device_access_peer(a, b)
             for b in range(count)] for a in range(count)],
             topology=nvidia_smi_topology())
    env = dict(os.environ)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker",
             str(r), str(world), tmp, backend]
            + (["--profile"] if profile else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    ok = (all(p.returncode == 0 for p in procs) and len(results) == world)
    emit("multi_card", ranks=world, backend=backend, seconds=seconds,
         results=results, ok=ok)
    if not ok:
        raise AssertionError("multi-card phase failed:\n" + "\n".join(
            log[-4000:] for log in logs))
    return results


def main(argv):
    if argv[:1] == ["--rank-worker"]:
        return rank_worker(int(argv[1]), int(argv[2]), argv[3], argv[4],
                           "--profile" in argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import torch.distributed as dist

    import graphem_rapids_torch as grt
    from graphem_rapids_torch import _build
    from graphem_rapids_torch.ops import knn_binfold as bf
    from graphem_rapids_torch.ops import knn_pallas as kp
    from graphem_rapids_torch.ops import segment as seg
    from graphem_rapids_torch.ops.knn import knn_exact
    from graphem_rapids_torch.parallel import ring_binfold as rb
    from graphem_rapids_torch.parallel.sharded_step import KNN_COMMS

    profile = "--profile" in argv
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_instr_per_s = n_sm * 128 * clock_mhz * 1e6
    print(smi, flush=True)
    emit("device", kind=kind, nvidia_smi=smi, sm_count=n_sm,
         max_sm_clock_mhz=clock_mhz, fp32_instr_per_s=fp32_instr_per_s,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    # every kernel and the host helpers' library, all compiled at once
    report = _build.build(
        sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")) + ["fastgraph"],
        force=True)
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    if "--multi-card" in argv:
        if phase_multi_card(profile=profile) is None:
            raise AssertionError("--multi-card needs two or more cards")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    k1 = phase_kernel(bf, fp32_instr_per_s, report, toolkit_k1_shape(grt))
    k2 = phase_kernel_k2(kp, knn_exact, fp32_instr_per_s, report)
    k3 = phase_kernel_k3(rb, bf, fp32_instr_per_s, report)
    phase_transfer(rb)
    log = spectral_log()
    adj100k, adj1m = regular_union_graph(100_000), ring_chords_graph()
    phase_host_prep([("random_8_regular_100k", adj100k, "flat"),
                     ("ring_chords_1m", adj1m, "binned")])
    ic = phase_ic_kernel(fp32_instr_per_s, adj100k, adj1m)
    adj12m = ring_chords_graph(SCATTER_N, 3 * SCATTER_N)
    scatter = phase_ic_scatter(fp32_instr_per_s, adj1m, adj12m)
    scatter_launches = phase_scatter_main(grt, adj12m, profile)
    scale_launches, k1_scale = phase_scale_main(grt, bf, adj12m,
                                                fp32_instr_per_s)
    del adj12m
    torch.cuda.empty_cache()
    starts = phase_spectral(log, [
        ("ring_chords_100k", ring_chords_graph(100_000, 300_000), "eigsh"),
        ("hub_chords_100k", hub_chords_graph(), "block_plan"),
        ("random_8_regular_100k", adj100k, "span"),
    ])
    runs = [phase_main(grt, bf, "random_8_regular_100k", adj100k, "flat",
                       "auto", warmup=10, profile=profile, log=log,
                       checked=k1["checked"]),
            phase_main(grt, bf, "ring_chords_1m", adj1m,
                       "binned+overflow plan", "auto", warmup=5,
                       profile=profile, log=log, checked=k1["checked"])]
    launches = scale_launches + sum(run["launches"] for run in runs)
    k2_launches, ic_launches = phase_quickstart(
        grt, bf, kp, "random_8_regular_100k", adj100k, "auto", warmup=5,
        profile=profile)
    k2_1m, ic_1m = phase_quickstart(grt, bf, kp, "ring_chords_1m", adj1m,
                                    "random", warmup=5, profile=profile)
    k2_launches += k2_1m
    greedy_ic, greedy_scatter = phase_greedy(grt)
    ic_launches += ic_1m + greedy_ic
    scatter_launches += greedy_scatter
    card9 = {strategy: phase_card_vs_cpu(grt, strategy)
             for strategy in ("binfold", "pallas", "approx")}
    phase_card_vs_cpu(grt, "binfold", ref_order="slot")
    phase_determinism(grt, runs, card9["pallas"])
    log.take("determinism")  # the twins' Chebyshev records
    del runs
    phase_graph_vs_eager(grt, "regular_2000", regular_union_graph(
        2000, cycles=3, seed=1), knn_strategy="binfold")
    phase_graph_vs_eager(grt, "random_8_regular_100k", adj100k)
    phase_approx(grt, bf, kp, "random_8_regular_100k", adj100k, "random", 5)
    phase_approx(grt, bf, kp, "ring_chords_1m", adj1m, "random", 3)
    launches += phase_main(grt, bf, "random_8_regular_100k_slot", adj100k,
                           "flat", "random", warmup=5, profile=profile,
                           log=log, checked=k1["checked"],
                           ref_order="slot")["launches"]

    with tempfile.TemporaryDirectory() as tmp:
        grt.distributed_init(backend="nccl", init_method=f"file://{tmp}/store",
                             world_size=1, rank=0)
        try:
            k3_launches, _ = phase_sharded(
                grt, bf, rb, "random_8_regular_100k", adj100k, "chebyshev",
                10, profile, log,
                start_ref=starts["random_8_regular_100k"])
            ring1m, _ = phase_sharded(grt, bf, rb, "ring_chords_1m", adj1m,
                                      "random", 5, profile, log)
            k3_launches += ring1m
            ring_slot, _ = phase_sharded(grt, bf, rb, "random_8_regular_100k",
                                         adj100k, "random", 5, profile, log,
                                         ref_order="slot")
            k3_launches += ring_slot
            _, k1_sharded = phase_sharded(grt, bf, rb, "ring_chords_1m",
                                          adj1m, "random", 3, profile, log,
                                          knn_comm="all_gather")
            launches += k1_sharded
            adj2k = regular_union_graph(2000, cycles=3, seed=1)
            for comm in KNN_COMMS:
                for order in ("row", "slot"):
                    phase_sharded_graph_vs_eager(grt, "regular_2000", adj2k,
                                                 comm, order)
            for comm in ("ring_pallas", "all_gather"):
                phase_sharded_graph_vs_eager(grt, "random_8_regular_100k",
                                             adj100k, comm)
            if profile:
                # the same one rank without a process group: collectives
                # return their input, so this prices the NCCL calls above
                phase_sharded(grt, bf, rb, "ring_chords_1m", adj1m, "random",
                              5, False, log,
                              mesh=grt.parallel.Mesh(1, 0, "cuda:0"))
            phase_sharded_vs_single(grt)
        finally:
            # before the store's directory goes: a live group would wait on
            # it at exit
            dist.destroy_process_group()
    launches += phase_toolkit(grt, bf, log, k1["checked"])
    phase_tiled(grt, "random_8_regular_100k", adj100k)
    RECORDED_SUMS.extend(skewed_static_calls())
    acc = phase_kernel_segment(seg, RECORDED_SUMS, MEM_BYTES_PER_S,
                               fp32_instr_per_s, clock_mhz * 1e6,
                               "skewed_1m hub plan")
    RECORDED_SUMS.clear()
    phase_multi_card(profile=profile)
    log.take("smoke run")

    print(json.dumps({"kernels": [{
        "name": "knn_binfold",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/binfold.cu",
        "replaces": "graphem_rapids_tpu/ops/knn_binfold.py:87",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "back_to_back_ms": k1["back_to_back_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        # phase 27's segmented call on the 12M graph's fused refs
        "segmented": {key: k1_scale[key] for key in (
            "refs", "n_seg", "ms", "back_to_back_ms", "plain_ms", "bound_ms",
            "max_abs_err")},
    }, {
        "name": "knn_pallas",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/knn_tiled.cu",
        "replaces": "graphem_rapids_tpu/ops/knn_pallas.py:37",
        "launches": k2_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "back_to_back_ms": k2["back_to_back_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }, {
        "name": "ring_binfold",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/ring_binfold.cu",
        "replaces": "graphem_rapids_tpu/parallel/ring_binfold.py:60",
        "launches": k3_launches,
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "back_to_back_ms": k3["back_to_back_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
    }, {
        "name": "ic_cascade",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/ic_cascade.cu",
        "replaces": "graphem_rapids_tpu/ops/ic_sim.py:116",
        "launches": ic_launches,
        "max_abs_err": ic["max_abs_err"],
        "ms": ic["ms"],
        "back_to_back_ms": ic["back_to_back_ms"],
        "plain_ms": ic["plain_ms"],
        "bound_ms": ic["bound_ms"],
        "bound_by": ic["bound_by"],
        "library_ms": None,
    }, {
        "name": "ic_scatter",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/ic_scatter.cu",
        "replaces": "graphem_rapids_tpu/ops/ic_sim.py:49",
        "launches": scatter_launches,
        "max_abs_err": scatter["max_abs_err"],
        "ms": scatter["ms"],
        "back_to_back_ms": scatter["back_to_back_ms"],
        "plain_ms": scatter["plain_ms"],
        "bound_ms": scatter["bound_ms"],
        "bound_by": scatter["bound_by"],
        "library_ms": None,
    }, {
        "name": "segment_sum_cluster",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/segment_sum.cu",
        "replaces": "graphem_rapids_tpu/ops/forces.py:1210",
        "launches": sum(PATH_CLUSTER_LAUNCHES),
        **acc["cluster"],
    }, {
        "name": "segment_sum",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/segment_sum.cu",
        "replaces": "graphem_rapids_tpu/ops/forces.py:922",
        "launches": sum(PATH_SEGMENT_LAUNCHES),
        **acc["sum"],
    }, {
        "name": "segment_sort_tiles",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/segment_sum.cu",
        "replaces": "graphem_rapids_tpu/ops/forces.py:1210",
        "launches": sum(PATH_SORT_LAUNCHES),
        **acc["sort"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
