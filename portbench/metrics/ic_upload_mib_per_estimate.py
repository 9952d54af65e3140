"""ic_upload_mib_per_estimate: MiB of edges the program copied to the card
(its counter ``ic.upload.bytes``) per estimate it recorded (its
``ic.estimate`` spans). Every estimate of a run scores the same graph, so
the warm-up's share is a window call's. A run that copied nothing (the
CPU), or a program without the counter, reads None."""

from portbench.harness import program_spans as ps


def read(run):
    if run.trace is None or run.kind != "spread":
        return None
    snap = ps.snapshot()
    if snap is None:
        return None
    sent = snap["counters"].get("ic.upload.bytes")
    estimates = snap["spans"].get("ic.estimate", {}).get("count", 0)
    if not sent or not estimates:
        return None
    return sent / 2**20 / estimates
