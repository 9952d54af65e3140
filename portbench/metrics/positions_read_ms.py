"""positions_read_ms: ms a window call spends copying the positions to the
host and permuting them to user order (the program's spans
layout.read.copy and layout.read.permute), per call. The wait for the
device to finish the call's replays (layout.read.wait) is left out."""

from portbench.harness import program_spans as ps


def read(run):
    if run.trace is None or run.kind != "layout":
        return None
    snap = ps.snapshot()
    calls = ps.benchmark_spans(run, "layout.call")
    if snap is None or not calls:
        return None
    recs = ps.inside(snap, calls, ("layout.read.copy", "layout.read.permute"))
    if not recs:
        return None
    return ps.seconds(recs) * 1e3 / len(calls)
