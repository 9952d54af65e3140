"""ic_cascade_ms_per_estimate: device ms of the push lists' build and the
cascade (the device work inside those spans) per estimate."""

from portbench.harness import trace as tr


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    n = run.spans.count("ic.estimate")
    s = tr.device_seconds(run.trace, within=("ic.push", "ic.cascade"))
    if not n or s <= 0:
        return None
    return s * 1e3 / n
