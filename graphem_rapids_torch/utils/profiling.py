"""Profiling and timing helpers.

Counterpart of ``graphem_rapids_tpu/utils/profiling.py``:

- ``time_fn``  : median seconds of a call; on a CUDA card between CUDA
                 events, after ``torch.cuda.synchronize``;
- ``trace``    : ``torch.profiler`` context that writes a Chrome trace;
- ``roofline`` : achieved FLOP/s and bytes/s against the card's peaks.
"""

import contextlib
import os
import time

import numpy as np
import torch

# Peaks for roofline fractions. H100 SXM: NVIDIA's data sheet (dense
# rates, at the full 700 W power limit), not a measurement. A card set
# below 700 W runs slower under load.
CHIP_PEAKS = {
    "h100": {"flops_bf16": 989e12, "flops_f32": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}
CHIP_PEAKS["default"] = CHIP_PEAKS["h100"]


def _chip_peaks():
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0).lower()
        for kind, peaks in CHIP_PEAKS.items():
            if kind in name:
                return peaks
    return CHIP_PEAKS["default"]


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


def roofline(name, seconds, flops=0, bytes_accessed=0, dtype="f32"):
    """Achieved rates and peak fractions for a timed kernel.

    Returns dict with achieved_tflops, achieved_gbps, flops_fraction,
    bandwidth_fraction, bound ('compute' | 'memory').
    """
    peaks = _chip_peaks()
    peak_flops = peaks["flops_bf16"] if dtype == "bf16" else peaks["flops_f32"]
    achieved_flops = flops / seconds if seconds > 0 else 0.0
    achieved_bw = bytes_accessed / seconds if seconds > 0 else 0.0
    f_frac = achieved_flops / peak_flops
    b_frac = achieved_bw / peaks["hbm_bytes_per_s"]
    return {
        "name": name,
        "seconds": seconds,
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbps": achieved_bw / 1e9,
        "flops_fraction": f_frac,
        "bandwidth_fraction": b_frac,
        "bound": "compute" if f_frac >= b_frac else "memory",
    }
