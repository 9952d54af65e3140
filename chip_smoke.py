#!/usr/bin/env python3
"""Smoke run of graphem_rapids_torch on one CUDA card.

    python3 chip_smoke.py             # the phases below, one JSON line each
    python3 chip_smoke.py --profile   # also a torch.profiler breakdown of
                                      # 10 iterations of each main-path graph

Phases:
1. device: the card's name, and its power limit and clocks from nvidia-smi;
2. build: every kernel of graphem_rapids_torch/csrc, built from source;
3. kernel against plain version: the bin-fold kernel (K1) and its plain
   PyTorch version on the same inputs, at the main path's shape (S=512,
   d=3, T=2048, G=24, 800,000 refs, some at the 1e30 pad), small ragged
   and G-clamped cases at d=2 and d=4, and the 1M graph's ref count on 64
   queries. Bins must be bit-equal with identical indices; after top-k the
   distances must be equal and the neighbour sets identical. Kernel and
   plain times are CUDA-event medians of 20 calls;
4. main path, 100K vertices: GraphEmbedderTorch on a random 8-regular
   graph (union of four random Hamiltonian cycles, seed 0), the force
   parameters of bench.py, scipy spectral init, then run_layout(50);
5. main path, 1M vertices: ring + 3M random chords as in bench.py,
   init='random', run_layout(50); binned table + overflow plan;
6. card against CPU: a small graph, 5 injected-sample steps with
   knn_strategy='binfold' on the card and on the CPU, allclose.

Each main-path phase zeroes the kernel's launch count just before its
timed run_layout and reads it just after. The line before the last is the
kernel summary {"kernels": [...]}; the last line is
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
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def profile_steps(emb, label, untraced_ms_per_iter, iters=10):
    """torch.profiler over ``iters`` steps: device time per iteration by
    kernel, and its share of the untraced wall time per iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # first use initializes CUPTI
        emb.run_layout(1, block_size=1)
    with profile(activities=activities) as prof:
        emb.run_layout(iters, block_size=iters)
    rows = [
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / iters
    emit("profile", graph=label, iters=iters,
         device_ms_per_iter=busy_ms,
         untraced_ms_per_iter=untraced_ms_per_iter,
         device_busy_share=busy_ms / untraced_ms_per_iter,
         kernels_per_iter=sum(r[2] for r in rows) / iters,
         top=[{"kernel": key[:90], "ms_per_iter": us / 1e3 / iters,
               "calls_per_iter": c / iters}
              for us, key, c in rows[:12]])


def phase_main(grt, bf, label, adj, expect_table, init, warmup, profile):
    """Phases 4/5: construct, warm up, then the timed run_layout."""
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


def phase_card_vs_cpu(grt):
    """Phase 6: the same injected-sample steps on the card and the CPU."""
    adj = regular_union_graph(2000, cycles=3, seed=1)
    kw = dict(n_components=3, seed=0, verbose=False, init="scipy",
              knn_strategy="binfold", **FORCE_PARAMS)
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
    emit("card_vs_cpu", n=gpu.n, E=gpu.n_edges, steps=5, max_abs_err=err,
         rtol=1e-4, atol=1e-5, allclose=ok)
    if not ok:
        raise AssertionError("card and CPU trajectories disagree")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import graphem_rapids_torch as grt
    from graphem_rapids_torch import _build
    from graphem_rapids_torch.ops import knn_binfold as bf

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
    launches = phase_main(grt, bf, "random_8_regular_100k",
                          regular_union_graph(100_000), "flat", "auto",
                          warmup=10, profile=profile)
    launches += phase_main(grt, bf, "ring_chords_1m", ring_chords_graph(),
                           "binned+overflow plan", "random", warmup=5,
                           profile=profile)
    phase_card_vs_cpu(grt)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
