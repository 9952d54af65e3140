"""tables_s: seconds spent making the neighbour tables during the engine's
set-up (the benchmark's span around build_neighbor_table*)."""


def read(run):
    if run.kind != "layout" or not run.spans.count("tables"):
        return None
    return run.spans.total("tables")
