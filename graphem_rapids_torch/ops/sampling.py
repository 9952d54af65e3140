"""Edge-midpoint sampling without replacement.

Below FAST_SAMPLE_MIN_EDGES a random permutation is cut to size; above it
the exact top-S of iid uniforms is taken, which is a uniform random
S-subset by exchangeability (the distribution the JAX package's
``approx_max_k`` path draws from off the TPU).
"""

import torch

FAST_SAMPLE_MIN_EDGES = 1 << 18


def sample_indices(generator, n_items, n_samples, device=None):
    """(n_samples,) int32 random subset of range(n_items), no replacement.

    ``generator`` is a ``torch.Generator`` on ``device``.
    """
    if n_samples >= n_items:
        return torch.arange(n_items, dtype=torch.int32, device=device)
    if n_items >= FAST_SAMPLE_MIN_EDGES:
        u = torch.rand(n_items, generator=generator, device=device)
        return torch.topk(u, n_samples, sorted=False).indices.to(torch.int32)
    perm = torch.randperm(n_items, generator=generator, device=device)
    return perm[:n_samples].to(torch.int32)
