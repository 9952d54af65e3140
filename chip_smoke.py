#!/usr/bin/env python3
"""Smoke run of graphem_rapids_torch on one CUDA card.

    python3 chip_smoke.py             # the phases below, one JSON line each
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown of
                                      # 10 iterations of each main-path and
                                      # quick-start graph, and of one IC call

Phases:
1. device: the card's name, and its power limit and clocks from nvidia-smi;
2. build: every kernel of graphem_rapids_torch/csrc, built from source,
   one nvcc per source, all started together;
3. K1 against its plain version: the bin-fold kernel and its plain
   PyTorch version on the same inputs, at the main path's shape (S=512,
   d=3, T=2048, G=24, 800,000 refs, some at the 1e30 pad), small ragged
   and G-clamped cases at d=2 and d=4, and the 1M graph's ref count on 64
   queries. Bins must be bit-equal with identical indices; after top-k the
   distances must be equal and the neighbour sets identical. Kernel and
   plain times are CUDA-event medians of 20 calls;
4. K2 against its plain version: the exact tiled kNN kernel and its plain
   version at S=512, d=3, k=16 against the midpoint counts of both graphs
   (399,984 and 3,999,991 refs), a ragged ref count, duplicated refs
   (exact ties), 1e30 pad rows leaving fewer than k refs, k=1, k=128,
   d=2 and d=4. Indices must be identical and values bit-equal. Times:
   the kernel, the plain version, the instruction bound, and as the
   library yardstick the port's knn_exact (difference-form distances and
   one torch.topk: two PyTorch calls, which the 'pallas' path never runs);
5. main path, 100K vertices: GraphEmbedderTorch on a random 8-regular
   graph (union of four random Hamiltonian cycles, seed 0), the force
   parameters of bench.py, scipy spectral init, then run_layout(50);
6. main path, 1M vertices: ring + 3M random chords as in bench.py,
   init='random', run_layout(50); binned table + overflow plan;
7. quick start, both graphs: create_graphem(backend='cuvs') (the 'pallas'
   strategy, K2), run_layout(50) timed, graphem_seed_selection (20 more
   iterations), then estimated_influence of the seeds and of 10 random
   vertices at p=0.1 over 64 runs, and the exact gates p=0 (exactly the
   seeds) and p=1 (exactly the seeds' connected components);
8. greedy: greedy_seed_selection on a small hub graph, the same seeds on
   the card and on the CPU;
9. card against CPU: a small graph, 5 injected-sample steps with
   knn_strategy='binfold' and 'pallas' on the card and on the CPU,
   allclose.

Each main-path and quick-start phase zeroes the kernels' launch counts
just before its timed run and reads them just after. The line before the
last is the kernel summary {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises and exits nonzero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

FORCE_PARAMS = dict(L_min=10.0, k_attr=0.5, k_inter=0.1, n_neighbors=15,
                    sample_size=512)
ITERS = 50
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


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


def phase_kernel(bf, fp32_instr_per_s):
    """Phase 3: K1 against its plain version on the card."""
    gen = torch.Generator(device="cpu").manual_seed(0)

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
        pv, pi = bf.binfold_bins_reference(q, r, T, G_eff, n_super)
        bins_equal = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
        err = float((kv - pv).abs().max())
        tk_v, tk_p = torch.topk(kv, k, dim=1, largest=False)
        tp_v, tp_p = torch.topk(pv, k, dim=1, largest=False)
        sets_k = torch.sort(torch.gather(ki, 1, tk_p), dim=1).values
        sets_p = torch.sort(torch.gather(pi, 1, tp_p), dim=1).values
        topk_equal = bool(torch.equal(tk_v, tp_v) and torch.equal(sets_k, sets_p))
        emit("kernel_check", case=name, S=q.shape[0], E=r.shape[0],
             d=q.shape[1], k=k, T=T, G=G_eff, n_super=n_super,
             bins_bit_equal=bins_equal, topk_equal=topk_equal,
             max_abs_err=err)
        if not (bins_equal and topk_equal):
            raise AssertionError(f"binfold kernel disagrees with plain: {name}")
        return G_eff, n_super, err

    S, d, k, E = 512, 3, 16, 800_000
    q, r = inputs(S, E, d, pad_rows=E // 40)
    G, n_super, err_main = check("main_100k", q, r, k)
    check("ragged_d2_gclamp", *inputs(7, 9001, 2), 4)
    check("ragged_d4_gclamp", *inputs(7, 20_000 + 77, 4), 5)
    q1m, r1m = inputs(64, 5_699_741, 3)
    check("ref_count_1m_64q", q1m, r1m, k)
    del q1m, r1m

    T = 2048
    kernel_ms = cuda_ms(lambda: bf.binfold_bins_cuda(q, r, T, G, n_super))
    plain_ms = cuda_ms(lambda: bf.binfold_bins_reference(q, r, T, G, n_super))
    E_pad = n_super * G * T
    ops = (3 * d + 3) * S * E_pad
    nbytes = 4 * (S * d + E * d) + 8 * S * G * 128
    ops_ms = ops / fp32_instr_per_s * 1e3
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    emit("kernel_time", name="knn_binfold", S=S, E=E, E_pad=E_pad, d=d,
         kernel_ms=kernel_ms, plain_ms=plain_ms, ops=ops, bytes=nbytes,
         ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)
    return {
        "max_abs_err": err_main, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def phase_kernel_k2(kp, knn_exact, fp32_instr_per_s):
    """Phase 4: K2 against its plain version on the card."""
    gen = torch.Generator(device="cpu").manual_seed(1)

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

    worst = 0.0

    def check(name, q, r, k):
        nonlocal worst
        ki, kv = kp.knn_tiled_cuda(q, r, k)
        torch.cuda.synchronize()
        pi, pv = kp.knn_tiled_reference(q, r, k)
        equal = bool(torch.equal(ki, pi) and torch.equal(kv, pv))
        err = float((kv - pv).abs().max())
        worst = max(worst, err)
        emit("kernel_check", kernel="knn_pallas", case=name, S=q.shape[0],
             E=r.shape[0], d=q.shape[1], k=k,
             slices=kp.slice_plan(q.shape[0], r.shape[0],
                                  torch.cuda.get_device_properties(0)
                                  .multi_processor_count)[0],
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
    check("pads_fewer_than_k", *inputs(16, 50_000, d, pad_keep=5), k)
    check("k1", *inputs(64, 300_000, d), 1)
    check("k128", *inputs(64, 300_000, d), 128)
    check("d2", *inputs(128, 150_000, 2), k)
    check("d4", *inputs(128, 150_000, 4), k)

    out = {"max_abs_err": worst}
    for label, q, r, plain_reps in (("100k", q100, r100, 10),
                                    ("1m", q1m, r1m, 3)):
        E = r.shape[0]
        kernel_ms = cuda_ms(lambda: kp.knn_tiled_cuda(q, r, k))
        plain_ms = cuda_ms(lambda: kp.knn_tiled_reference(q, r, k),
                           reps=plain_reps, warmup=1)
        ops = (3 * d + 1) * S * E
        nbytes = 4 * (S * d + E * d) + 8 * S * k
        ops_ms = ops / fp32_instr_per_s * 1e3
        bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
        library_ms = (cuda_ms(lambda: knn_exact(q, r, k), reps=10)
                      if label == "100k" else None)
        emit("kernel_time", name="knn_pallas", shape=label, S=S, E=E, d=d,
             k=k, kernel_ms=kernel_ms, plain_ms=plain_ms, ops=ops,
             bytes=nbytes, ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
             library="knn_exact (squared_distances + torch.topk)",
             library_ms=library_ms)
        if label == "100k":
            out.update(ms=kernel_ms, plain_ms=plain_ms,
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms
                       else "bytes",
                       library_ms=library_ms)
    return out


def phase_quickstart(grt, bf, kp, label, adj, init, warmup, profile):
    """Phase 7: create_graphem(backend='cuvs') -> run_layout ->
    graphem_seed_selection -> estimated_influence, on the card."""
    from scipy.sparse.csgraph import connected_components

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
    t0 = time.perf_counter()
    pos = emb.run_layout(ITERS, block_size=10)
    dt = time.perf_counter() - t0
    seeds = grt.graphem_seed_selection(emb, k=10)
    launches = kp.knn_pallas.launches
    iters = ITERS + 20
    emit("quickstart_run", graph=label, iters=ITERS, seconds=dt,
         ms_per_iter=dt / ITERS * 1e3, edges_per_s=emb.n_edges * ITERS / dt,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         knn_pallas_launches=launches, binfold_launches=bf.knn_binfold.launches,
         iterations_run=iters, seeds=seeds)
    if launches != iters or bf.knn_binfold.launches != 0:
        raise AssertionError(f"{label}: {launches} K2 launches in {iters} "
                             "iterations")
    if pos.shape != (emb.n, 3) or not np.isfinite(emb.positions).all():
        raise AssertionError(f"{label}: positions not finite")
    if len(set(seeds)) != 10:
        raise AssertionError(f"{label}: seeds {seeds}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spread = grt.estimated_influence(adj, seeds, p=0.1, num_sims=64)
    ic_s = time.perf_counter() - t0
    rand = np.random.default_rng(0).choice(emb.n, 10, replace=False).tolist()
    spread_rand = grt.estimated_influence(adj, rand, p=0.1, num_sims=64)
    p0 = grt.estimated_influence(adj, seeds, p=0.0, num_sims=8)
    p1 = grt.estimated_influence(adj, seeds, p=1.0, num_sims=4)
    _, comp = connected_components(adj, directed=False)
    exact_p1 = int(np.isin(comp, comp[seeds]).sum())
    emit("quickstart_influence", graph=label, p=0.1, num_sims=64,
         ic_seconds=ic_s, spread_graphem=spread, spread_random=spread_rand,
         p0_spread=p0, p1_spread=p1, p1_exact=exact_p1)
    if p0 != 10.0 or p1 != exact_p1:
        raise AssertionError(f"{label}: IC gates p=0 -> {p0} (want 10), "
                             f"p=1 -> {p1} (want {exact_p1})")
    if profile:
        profile_steps(emb, label + "_pallas", dt / ITERS * 1e3)
        profile_call(
            "profile_ic", label,
            lambda: grt.estimated_influence(adj, rand, p=0.1, num_sims=64),
            lambda: grt.estimated_influence(adj, seeds, p=0.1, num_sims=64),
            ic_s * 1e3, 1)
    return launches


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


def phase_greedy(grt):
    """Phase 8: greedy seeds on the card equal those on the CPU."""
    adj = hub_graph()
    kw = dict(p=0.2, iterations_count=50, num_sims=32, seed=0)
    t0 = time.perf_counter()
    card, evals = grt.greedy_seed_selection(adj, 3, **kw)
    dt = time.perf_counter() - t0
    cpu, _ = grt.greedy_seed_selection(adj, 3, device="cpu", **kw)
    emit("greedy", n=adj.shape[0], seeds_card=card, seeds_cpu=cpu,
         evaluations=evals, seconds_card=dt)
    if card != cpu:
        raise AssertionError(f"greedy seeds differ: card {card}, cpu {cpu}")


def profile_steps(emb, label, untraced_ms_per_iter, iters=10):
    """torch.profiler over ``iters`` steps: device time per iteration by
    kernel, and its share of the untraced wall time per iteration."""
    profile_call("profile", label, lambda: emb.run_layout(1, block_size=1),
                 lambda: emb.run_layout(iters, block_size=iters),
                 untraced_ms_per_iter, iters)


def profile_call(phase, label, warm, fn, untraced_ms, per):
    """torch.profiler over ``fn()``: device ms by kernel divided by ``per``,
    and the busy share against ``untraced_ms`` (wall ms per ``per``)."""
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
    emit(phase, graph=label, per=per,
         device_ms_per_iter=busy_ms,
         untraced_ms_per_iter=untraced_ms,
         device_busy_share=busy_ms / untraced_ms,
         kernels_per_iter=sum(r[2] for r in rows) / per,
         top=[{"kernel": key[:90], "ms_per_iter": us / 1e3 / per,
               "calls_per_iter": c / per}
              for us, key, c in rows[:12]])


def phase_main(grt, bf, label, adj, expect_table, init, warmup, profile):
    """Phases 5/6: construct, warm up, then the timed run_layout."""
    t0 = time.perf_counter()
    emb = grt.GraphEmbedderTorch(adj, n_components=3, seed=0, verbose=False,
                                 init=init, **FORCE_PARAMS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit("main_setup", graph=label, n=emb.n, E=emb.n_edges,
         table=emb.table_kind, strategy=emb._strategy,
         fused_refs=emb._fused_refs_active,
         refs=int(len(emb._nb["ref_edge"])),
         overflow_pairs=int(len(emb._nb["overflow"])), init=init,
         init_s=init_s)
    if emb.table_kind != expect_table:
        raise AssertionError(f"{label}: table {emb.table_kind}, "
                             f"expected {expect_table}")
    if emb._strategy != "binfold" or not emb._fused_refs_active:
        raise AssertionError(f"{label}: main path must take fused binfold")
    emb.run_layout(warmup, block_size=warmup)

    bf.knn_binfold.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pos = emb.run_layout(ITERS, block_size=10)
    dt = time.perf_counter() - t0
    launches = bf.knn_binfold.launches
    std = pos.std(axis=0, ddof=1)
    emit("main_run", graph=label, iters=ITERS, seconds=dt,
         ms_per_iter=dt / ITERS * 1e3, edges_per_s=emb.n_edges * ITERS / dt,
         binfold_launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         finite=bool(np.isfinite(pos).all()), std=std.tolist())
    if launches != ITERS:
        raise AssertionError(f"{label}: {launches} kernel launches in "
                             f"{ITERS} iterations")
    if pos.shape != (emb.n, 3) or not np.isfinite(pos).all():
        raise AssertionError(f"{label}: positions not finite")
    if not np.allclose(std, 1.0, atol=1e-3):
        raise AssertionError(f"{label}: per-axis std {std} is not ~1")
    if profile:
        profile_steps(emb, label, dt / ITERS * 1e3)
    return launches


def phase_card_vs_cpu(grt, strategy):
    """Phase 9: the same injected-sample steps on the card and the CPU."""
    adj = regular_union_graph(2000, cycles=3, seed=1)
    kw = dict(n_components=3, seed=0, verbose=False, init="scipy",
              knn_strategy=strategy, **FORCE_PARAMS)
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
    emit("card_vs_cpu", strategy=strategy, n=gpu.n, E=gpu.n_edges, steps=5,
         max_abs_err=err, rtol=1e-4, atol=1e-5, allclose=ok)
    if not ok:
        raise AssertionError(f"card and CPU trajectories disagree ({strategy})")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import graphem_rapids_torch as grt
    from graphem_rapids_torch import _build
    from graphem_rapids_torch.ops import knn_binfold as bf
    from graphem_rapids_torch.ops import knn_pallas as kp
    from graphem_rapids_torch.ops.knn import knn_exact

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
    report = _build.build(force=True)
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"seconds": v["seconds"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for k, v in report.items()})

    k1 = phase_kernel(bf, fp32_instr_per_s)
    k2 = phase_kernel_k2(kp, knn_exact, fp32_instr_per_s)
    adj100k, adj1m = regular_union_graph(100_000), ring_chords_graph()
    launches = phase_main(grt, bf, "random_8_regular_100k", adj100k, "flat",
                          "auto", warmup=10, profile=profile)
    launches += phase_main(grt, bf, "ring_chords_1m", adj1m,
                           "binned+overflow plan", "random", warmup=5,
                           profile=profile)
    k2_launches = phase_quickstart(grt, bf, kp, "random_8_regular_100k",
                                   adj100k, "auto", warmup=5, profile=profile)
    k2_launches += phase_quickstart(grt, bf, kp, "ring_chords_1m", adj1m,
                                    "random", warmup=5, profile=profile)
    phase_greedy(grt)
    for strategy in ("binfold", "pallas"):
        phase_card_vs_cpu(grt, strategy)

    print(json.dumps({"kernels": [{
        "name": "knn_binfold",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/binfold.cu",
        "replaces": "graphem_rapids_tpu/ops/knn_binfold.py:87",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "knn_pallas",
        "route": "cuda",
        "source": "graphem_rapids_torch/csrc/knn_tiled.cu",
        "replaces": "graphem_rapids_tpu/ops/knn_pallas.py:37",
        "launches": k2_launches,
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
