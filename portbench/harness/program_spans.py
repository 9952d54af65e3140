"""The program's own spans and counters, as the metric readers see them.

The program records spans inside itself (``graphem_rapids_torch/utils/
tracing.py``): ``snapshot()`` gives each span's name, start and end in ns
of ``time.perf_counter``, the clock of the benchmark's own spans
(``harness/spans.py``, in seconds), and its counters. A checkout whose
program has no such module has none of them: ``snapshot`` is then None and
every reader built on this file returns None.

A traced run's window is told apart by the benchmark's own records
(``run.spans.records``): the program's spans of a window call lie inside
one of the benchmark's spans around that call (``layout.call``,
``ic.estimate``), which leaves out the warm-up and the check's calls. The
set-up's stages are the program's spans that overlap the benchmark's
set-up spans of the same run (``tables``, ``spectral``).
"""


def snapshot():
    """The program's ``tracing.snapshot()``, or None without one."""
    try:
        from graphem_rapids_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def benchmark_spans(run, name):
    """[(start_s, end_s), ...] of the benchmark's spans ``name``."""
    return [(t0, t1) for n, t0, t1 in run.spans.records if n == name]


def _seconds(rec):
    return rec["start_ns"] / 1e9, rec["end_ns"] / 1e9


def inside(snap, outer, names):
    """The program's spans of these ``names`` that lie inside one of the
    ``outer`` intervals (seconds; a microsecond of slack for rounding)."""
    picked = []
    for rec in snap["recent"]:
        if rec["name"] not in names:
            continue
        s, e = _seconds(rec)
        if any(a - 1e-6 <= s and e <= b + 1e-6 for a, b in outer):
            picked.append(rec)
    return picked


def overlapping(snap, outer, name):
    """The program's spans ``name`` that overlap one of the ``outer``
    intervals (seconds)."""
    picked = []
    for rec in snap["recent"]:
        if rec["name"] != name:
            continue
        s, e = _seconds(rec)
        if any(s < b and a < e for a, b in outer):
            picked.append(rec)
    return picked


def seconds(recs):
    """Total seconds of program spans."""
    return sum(r["end_ns"] - r["start_ns"] for r in recs) / 1e9


def setup_seconds(run, outer_name, name):
    """Seconds of the program's set-up span ``name`` over the spans that
    overlap the benchmark's set-up spans ``outer_name``, or None."""
    if run.kind != "layout":
        return None
    snap = snapshot()
    outer = benchmark_spans(run, outer_name)
    if snap is None or not outer:
        return None
    recs = overlapping(snap, outer, name)
    return seconds(recs) if recs else None
