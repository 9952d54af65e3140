"""ic_over_budget_plan_s_per_estimate: seconds of the program's ``ic.plan``
spans inside the window's estimates, per estimate, where every plan of the
run stopped past the table budget: the work the scatter form throws away
(the edges' upload, the degrees' sorts, the cap model). Read only where
the program's counter ``ic.plan.over_budget`` equals the count of its
``ic.plan`` spans; a run with a plan that was built, or a program without
the counter, reads None."""

from portbench.harness import program_spans as ps


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    snap = ps.snapshot()
    calls = ps.benchmark_spans(run, "ic.estimate")
    if snap is None or not calls:
        return None
    plans = snap["spans"].get("ic.plan", {}).get("count", 0)
    if not plans or snap["counters"].get("ic.plan.over_budget") != plans:
        return None
    recs = ps.inside(snap, calls, ("ic.plan",))
    if not recs:
        return None
    return ps.seconds(recs) / len(calls)
