"""The ``ring`` family (``experiments/bench_10m.py``): chords with both
ends uniform on [0, n)."""

import torch


def chords(n, count, spec, gen, device):
    """(first ends, second ends) of ``count`` chords, int64."""
    return torch.randint(0, n, (count, 2), generator=gen, device=device,
                         dtype=torch.int64).unbind(1)
