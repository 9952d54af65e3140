"""k1_ms_per_iter: device ms of the bin-fold kernel (every segment's
launch) in the traced window, per replayed iteration."""

from portbench.harness import kernels, trace as tr


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    s = tr.device_seconds(run.trace, kernels.is_k1)
    if s <= 0:
        return None
    return s * 1e3 / kernels.iterations(run)
