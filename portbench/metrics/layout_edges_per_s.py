"""layout_edges_per_s: E x iterations completed in the window over the
wall seconds from its start to the end of its last whole call."""


def read(run):
    if run.kind != "layout" or run.trace is not None:
        return None
    return run.window["work"] / run.window["seconds"]
