"""setup_s: wall seconds from the harness's first line to the window's
start (imports, the CUDA context, the graph drawn from the seed, the
program's set-up and the warm-up call)."""


def read(run):
    return run.setup_s
