"""accumulator_ms_per_iter: device ms of the force accumulator's kernels
(the static sum, the cluster sum, the tile sort and the tiled sum) in the
traced window, per replayed iteration."""

from portbench.harness import kernels, trace as tr


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    s = tr.device_seconds(run.trace, kernels.is_accumulator)
    if s <= 0:
        return None
    return s * 1e3 / kernels.iterations(run)
