"""ic_host_s_per_estimate: seconds in the estimate's host stages (the edge
extraction, the cascade plan and its upload; spans) per estimate."""


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    n = run.spans.count("ic.estimate")
    if not n:
        return None
    return run.spans.total("ic.extract", "ic.plan", "ic.upload") / n
