"""device_idle_share.spread: 1 - the union of the device's operations
over the traced window of whole estimates, %."""

from portbench.harness import trace as tr


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    return 100.0 * (1.0 - tr.busy_seconds(run.trace) / run.trace.window_s)
