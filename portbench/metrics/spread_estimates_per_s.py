"""spread_estimates_per_s: whole estimates completed in the window over
the wall seconds from its start to the end of the last one."""


def read(run):
    if run.kind != "spread" or run.trace is not None:
        return None
    return run.window["work"] / run.window["seconds"]
