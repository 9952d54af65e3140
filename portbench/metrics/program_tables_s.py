"""program_tables_s: seconds of the engine's set-up stage setup.tables,
the program's own span around the neighbour-table builders (its stages
tables.* inside it)."""

from portbench.harness import program_spans as ps


def read(run):
    return ps.setup_seconds(run, "tables", "setup.tables")
