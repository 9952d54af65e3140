"""ic_cascade_roofline: the least time the card could take for the
cascades' work, as a share (%) of the cascade kernel's traced time.

The work is the bytes a cascade along its push lists must move (PERF.md's
push bound): the (n, W) seed words read and the active words written, W =
ceil(B / 32) for B runs, the B counts, the steps and the key, the row
starts (two int32) of each vertex that was in the frontier, and the
receiver and slot (two int32) of each push-list pair behind them:
4 (2 n W + B + 1) + 16 + 8 sources + 8 pushed bytes, against the memory
rate. The program counts sources and pushed (ic.sources, ic.pushed) in a
span ic.stats of each cascade while the profiler records; the metric is
read only where every window estimate has one and no other cascade added
to the counters."""

from portbench.harness import peaks, program_spans as ps, trace as tr

CASCADE_KERNELS = ("ic_cascade_kernel", "ic_scatter_kernel")


def _is_cascade(name):
    return any(k in name for k in CASCADE_KERNELS)


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    snap = ps.snapshot()
    calls = ps.benchmark_spans(run, "ic.estimate")
    if snap is None or not calls:
        return None
    counted = ps.inside(snap, calls, ("ic.stats",))
    recorded = snap["spans"].get("ic.stats", {}).get("count", 0)
    if len(counted) != len(calls) or recorded != len(counted):
        return None
    s = tr.device_seconds(run.trace, _is_cascade)
    if s <= 0:
        return None
    n, B = run.facts["n"], run.facts["num_sims"]
    W = -(-B // 32)
    c = snap["counters"]
    work = (len(calls) * (4 * (2 * n * W + B + 1) + 16)
            + 8 * (c["ic.sources"] + c["ic.pushed"]))
    return 100.0 * work / peaks.HBM_BYTES_PER_S / s
