"""step_passes_ms_per_iter: device ms of every other kernel of the
replayed iterations (the gathers, springs, midpoints, K1's top-k merge,
intersections and standardization), per iteration."""

from portbench.harness import kernels, trace as tr


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    s = tr.device_seconds(run.trace, kernels.is_step_pass)
    if s <= 0:
        return None
    return s * 1e3 / kernels.iterations(run)
