"""Spans the benchmark records around the calls into the program's layers.

A span is (name, start, end) on the host's clock. The benchmark takes them
from outside: ``Spans.wrap`` swaps a module's attribute for a wrapper that
records a span around each call and puts the original back on exit. Inside
a profiled window each span is also a ``record_function`` range, so that
the trace can say what the host was doing while the device was idle.
With ``sync`` the wrapper waits for the device before it closes the span,
so that the device work of the call falls inside it (traced runs only).
"""

import contextlib
import time

import torch


class Spans:
    def __init__(self, sync=False):
        self.records = []
        self.sync = sync
        self.profiled = False

    @contextlib.contextmanager
    def span(self, name):
        rf = (torch.profiler.record_function(f"pb:{name}") if self.profiled
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
                if self.sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def total(self, *names):
        """Seconds spent in spans of these names."""
        return sum(t1 - t0 for n, t0, t1 in self.records if n in names)

    def count(self, name):
        return sum(1 for n, _, _ in self.records if n == name)

    @contextlib.contextmanager
    def wrap(self, targets):
        """Inside, each (owner, attribute, span name) of ``targets`` records
        a span around every call. A property is wrapped as a property."""
        saved = []
        for owner, attr, name in targets:
            fn = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrapped(fn, name))
        try:
            yield self
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    def _wrapped(self, fn, name):
        if isinstance(fn, property):
            getter = fn.fget

            def get(obj):
                with self.span(name):
                    return getter(obj)
            return property(get, fn.fset)

        def call(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return call
