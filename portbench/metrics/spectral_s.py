"""spectral_s: seconds in spectral_init during the engine's set-up (the
Chebyshev on the card, or the random start), device work included."""


def read(run):
    if run.kind != "layout" or not run.spans.count("spectral"):
        return None
    return run.spans.total("spectral")
