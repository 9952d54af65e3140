"""device_idle_share.layout: 1 - the union of the device's operations
over the traced window of whole run_layout calls (reads included), %."""

from portbench.harness import trace as tr


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    return 100.0 * (1.0 - tr.busy_seconds(run.trace) / run.trace.window_s)
