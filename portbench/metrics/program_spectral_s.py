"""program_spectral_s: seconds of the engine's set-up stage
setup.spectral, the program's own span around the spectral start (the
Chebyshev's spectral.plan and spectral.iterate inside it, or the random
start)."""

from portbench.harness import program_spans as ps


def read(run):
    return ps.setup_seconds(run, "spectral", "setup.spectral")
