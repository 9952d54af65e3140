"""A profiled window and what the benchmark reads from it.

``profile_window(fn, spans)`` runs ``fn`` under ``torch.profiler`` (host and
CUDA activities) inside a ``pb:window`` range and returns a ``Trace``: the
window's interval, the device's operations (kernels, copies and sets)
clipped to it, and the benchmark's spans, all in microseconds on the
profiler's clock.

From a Trace: the device's busy time is the length of the union of its
operations' intervals (so overlapping operations count once and the busy
share can never pass 1), the idle time the window less that, each idle
gap named by the innermost benchmark span open at its middle.
"""

from dataclasses import dataclass, field

import torch

WINDOW = "pb:window"


@dataclass
class Trace:
    window: tuple
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    spans: list = field(default_factory=list)   # (name, start_us, end_us)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_seconds(trace):
    return sum(b - a for a, b in union(
        (s, e) for _, s, e in trace.device)) / 1e6


def gaps(trace):
    """The idle intervals of the window between the device's operations."""
    t0, t1 = trace.window
    out, at = [], t0
    for a, b in union((s, e) for _, s, e in trace.device):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def innermost_span(trace, t):
    """The name of the innermost benchmark span open at time ``t``."""
    best = None
    for name, s, e in trace.spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "harness"


def idle_by_span(trace, top=10):
    """[[span name, idle seconds], ...], most idle first."""
    acc = {}
    for a, b in gaps(trace):
        name = innermost_span(trace, (a + b) / 2)
        acc[name] = acc.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            ][:top]


def device_time_by_name(trace, top=10, width=160):
    """[[device operation, seconds], ...], longest first; each name cut to
    its first ``width`` characters."""
    acc = {}
    for name, s, e in trace.device:
        name = name[:width]
        acc[name] = acc.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            ][:top]


def device_seconds(trace, match=None, within=None):
    """Seconds of device operations whose name ``match`` accepts, and
    (with ``within``, a list of span names) that lie inside those spans.
    Overlapping operations are counted once."""
    spans = None
    if within is not None:
        spans = union((s, e) for n, s, e in trace.spans if n in within)
    picked = []
    for name, s, e in trace.device:
        if match is not None and not match(name):
            continue
        if spans is not None:
            mid = (s + e) / 2
            if not any(a <= mid <= b for a, b in spans):
                continue
        picked.append((s, e))
    return sum(b - a for a, b in union(picked)) / 1e6


def _warm_profiler():
    """The profiler's first use initializes CUPTI: do it outside."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_window(fn, spans):
    """Run ``fn()`` in a profiled window; returns (fn's result, Trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        _warm_profiler()
        activities.append(ProfilerActivity.CUDA)
    spans.profiled = True
    try:
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                out = fn()
                if cuda:
                    torch.cuda.synchronize()
    finally:
        spans.profiled = False
    window, dev, marks = None, [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.name == WINDOW and ev.device_type == DeviceType.CPU:
            window = (start, end)
        elif ev.name.startswith("pb:"):
            if ev.device_type == DeviceType.CPU:
                marks.append((ev.name[3:], start, end))
        elif ev.device_type == DeviceType.CUDA and end > start:
            dev.append((ev.name, start, end))
    if window is None:
        raise RuntimeError("the profiled window left no trace")
    t0, t1 = window
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in dev if e > t0 and s < t1]
    return out, Trace(window=window, device=dev, spans=marks)
