"""k1_roofline: the least time the card could take for K1's work, as a
share (%) of its traced time. The work is every sampled midpoint against
every fused ref (S x R pairs, 3d+2 fp32 instructions a pair) against the
instruction rate, or the refs and queries read once and the top-k written
once against the memory rate, whichever is longer."""

from portbench.harness import kernels, peaks, trace as tr


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    s = tr.device_seconds(run.trace, kernels.is_k1)
    if s <= 0:
        return None
    f = run.facts
    bound = peaks.k1_bound_s(f["S"], f["refs"], f["d"], f["k"])
    return 100.0 * bound / (s / kernels.iterations(run))
