"""The ``skewed`` family (``experiments/bench_1m_skewed.py``): a chord's
first end is min(Z, n) - 1 with Z ~ zipf(``zipf_a``), drawn by the inverse
of its exact CDF truncated at n; its second end is uniform."""

import scipy.special
import torch


def zipf_ranks(count, a, n, gen, device):
    """``count`` draws of min(Z, n) - 1, Z ~ zipf(a), int64."""
    k = torch.arange(1, n, dtype=torch.float64, device=device)
    mass = k.pow(-a) / float(scipy.special.zeta(a))
    cdf = torch.cumsum(mass, 0)  # P(Z <= k) for k < n; P(Z >= n) is left
    u = torch.rand(count, dtype=torch.float64, generator=gen, device=device)
    return torch.searchsorted(cdf, u, right=True)


def chords(n, count, spec, gen, device):
    """(first ends, second ends) of ``count`` chords, int64."""
    za = zipf_ranks(count, float(spec["zipf_a"]), n, gen, device)
    zb = torch.randint(0, n, (count,), generator=gen, device=device,
                       dtype=torch.int64)
    return za, zb
