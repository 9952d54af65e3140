"""peak_device_gib: the allocator's peak over the program's set-up and
the window (torch.cuda.max_memory_allocated, reset once the benchmark's
graph is drawn), in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
