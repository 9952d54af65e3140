"""Spans and counters recorded inside the program, always on.

A span is one stretch of host time at a layer boundary::

    with tracing.span("layout.read"):
        ...

It records its name, its start and end (``time.perf_counter_ns()``, the
clock of ``time.perf_counter``), the span open in the same thread when it
began (its parent), and a call id: a span opened with no span open starts a
new call, and every span under it shares the id. While a ``torch.profiler``
is recording, a span is also a host range of the same name in the trace
(the kind of event an operator records, not a user annotation, which the
profiler would copy onto the device's timeline), so that it lies on the
trace's clock beside the device's operations (``utils.profiling.trace``'s
Chrome trace, or any profiled window).

Per name the module keeps the count, the total and the self time (the span
less the time its child spans cover), and it keeps the last ``RING`` spans
whole, so that a long-lived process does not grow. ``count(name, k)`` adds
to a counter. ``snapshot()`` returns all of it, with the own counters of
the kernel wrappers that ``counts_launches`` registered (each one's
``launches``, the push lists' ``builds``) read in under
``launches.<wrapper>``; ``reset()`` clears what this module holds.

Recording costs a few microseconds of host time a span (2-4 on an H100's
host, PERF.md): a layout call of 100 iterations records 15 spans, an
estimate 10.
"""

import collections
import itertools
import threading
import time

import torch

# Raw spans kept whole, the most recent ones.
RING = 65536


class _Recorder:
    """What the module records: per-name totals, the recent spans, the
    counters. One per process (``_REC``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self):
        with self.lock:
            self.totals = {}  # name -> [count, total_ns, self_ns]
            self.recent = collections.deque(maxlen=RING)
            self.counters = collections.Counter()
            self.ids = itertools.count(1)
            self.calls = itertools.count(1)

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


def profiling():
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch.autograd._profiler_enabled()


# A span's range in a profiler's trace: a host event of its name, the kind
# an operator records. ``torch.profiler.record_function`` would make it a
# user annotation, which the CUDA activity copies onto the device's
# timeline as an event of the same name spanning the kernels launched
# inside it: a trace that sums device events would count those twice. A
# torch without this private class records the spans with no range.
_Range = getattr(getattr(torch._C, "_profiler", None),
                 "_RecordFunctionFast", None)


class span:
    """Context manager recording one span (see the module docstring).
    ``seconds`` reads its length once it has closed."""

    __slots__ = ("name", "id", "parent", "call", "start", "end", "child_ns",
                 "_rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        st = _REC.stack()
        parent = st[-1] if st else None
        self.id = next(_REC.ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else next(_REC.calls)
        self.child_ns = 0
        self._rf = None
        if _Range is not None and profiling():
            self._rf = _Range(self.name)
            self._rf.__enter__()
        st.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        st = _REC.stack()
        if st and st[-1] is self:
            st.pop()
        else:
            st.remove(self)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        dur = self.end - self.start
        if st:
            st[-1].child_ns += dur
        with _REC.lock:
            t = _REC.totals.get(self.name)
            if t is None:
                t = _REC.totals[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += dur
            t[2] += dur - self.child_ns
            _REC.recent.append((self.id, self.name, self.start, self.end,
                                self.parent, self.call))
        return False

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9


def count(name, k=1):
    """Add ``k`` to the counter ``name``."""
    with _REC.lock:
        _REC.counters[name] += k


# wrapper name -> (wrapper, name of its counter attribute)
_WRAPPERS = {}


def counts_launches(fn, attr="launches"):
    """Register a kernel wrapper whose ``fn.<attr>`` counts its launches
    (or builds), so that ``snapshot()`` reads it in as
    ``launches.<fn.__name__>``. Returns ``fn``."""
    _WRAPPERS[fn.__name__] = (fn, attr)
    return fn


def snapshot():
    """{'spans': {name: {'count', 'total_ns', 'self_ns'}}, 'recent': [{'id',
    'name', 'start_ns', 'end_ns', 'parent', 'call'}, ...] (oldest first, at
    most RING), 'counters': {name: value}}, the counters with the kernel
    wrappers' counters read in as ``launches.<wrapper>``."""
    with _REC.lock:
        spans = {name: {"count": c, "total_ns": tot, "self_ns": own}
                 for name, (c, tot, own) in _REC.totals.items()}
        recent = [{"id": i, "name": n, "start_ns": s, "end_ns": e,
                   "parent": p, "call": c}
                  for i, n, s, e, p, c in _REC.recent]
        counters = dict(_REC.counters)
    counters.update({f"launches.{name}": getattr(fn, attr)
                     for name, (fn, attr) in _WRAPPERS.items()})
    return {"spans": spans, "recent": recent, "counters": counters}


def reset():
    """Clear the spans and counters recorded so far (not the wrappers'
    ``launches``, which belong to them)."""
    _REC.reset()
