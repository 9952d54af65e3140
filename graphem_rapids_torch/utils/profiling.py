"""Profiling and timing helpers.

Counterpart of ``graphem_rapids_tpu/utils/profiling.py``:

- ``time_fn``  : median seconds of a call; on a CUDA card between CUDA
                 events, after ``torch.cuda.synchronize``;
- ``trace``    : ``torch.profiler`` context that writes a Chrome trace
                 (the program's spans, ``utils/tracing.py``, appear in it
                 as ranges of their names).
"""

import contextlib
import os
import time

import numpy as np
import torch


def time_fn(fn, *args, reps=10, warmup=2, **kwargs):
    """Median seconds of ``fn(*args, **kwargs)`` over ``reps`` calls.

    With a CUDA card each call is timed between two CUDA events and the
    device is synchronized before the events are read, so queued work is
    counted. Without one, the host clock times each call (a CPU time,
    never a device time).
    """
    for _ in range(warmup):
        fn(*args, **kwargs)
    cuda = torch.cuda.is_available()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (the CPU, and CUDA where there is a
    card); writes ``trace.json`` (Chrome/Perfetto format) into ``log_dir``
    and yields the profiler, whose ``key_averages()`` sums by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
