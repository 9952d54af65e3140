"""program_ic_host_s_per_estimate: seconds of the estimate's host stages
as the program records them (its spans ic.extract, ic.plan and ic.upload
inside the window's estimates), per estimate."""

from portbench.harness import program_spans as ps


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    snap = ps.snapshot()
    calls = ps.benchmark_spans(run, "ic.estimate")
    if snap is None or not calls:
        return None
    recs = ps.inside(snap, calls, ("ic.extract", "ic.plan", "ic.upload"))
    if not recs:
        return None
    return ps.seconds(recs) / len(calls)
