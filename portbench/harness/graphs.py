"""The cells' graphs, drawn from the run's seed on the run's device.

Each family is a procedure of the JAX package's experiment scripts
(``experiments/bench_1m_skewed.py``, ``experiments/bench_10m.py``): a ring
on n vertices plus chords, self loops dropped, duplicates merged, the
result symmetrized with every value 1. A family's chords are drawn by its
own module, ``graphs/<family>.py`` under the benchmark's paths
(``registry.family``); the draws are torch's on the device, from a
``torch.Generator`` seeded with the run's seed, so the graph differs from
seed to seed and the distribution is the scripts'.

The graph is handed to both sides as a scipy CSR matrix with sorted
indices, as a user would hand it to ``create_graphem``.
"""

import numpy as np
import scipy.sparse as sp
import torch


def make_graph(spec, seed, device, chords):
    """(scipy CSR adjacency, stats): the config's ``graph`` drawn from
    ``seed`` on ``device``, its chords by the family's ``chords``."""
    n = int(spec["vertices"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a, b = chords(n, int(spec["chords"]), spec, gen, device)
    keep = a != b
    ring = torch.arange(n, device=device)
    a = torch.cat([ring, a[keep]])
    b = torch.cat([(ring + 1) % n, b[keep]])
    del keep
    key = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    del a, b
    lo, hi = key // n, key % n
    rows = torch.cat([lo, hi])
    cols = torch.cat([hi, lo])
    del key, lo, hi
    order = torch.argsort(rows * n + cols)
    rows, cols = rows[order], cols[order]
    deg = torch.bincount(rows, minlength=n)
    del rows, order
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg.cpu().numpy(), out=indptr[1:])
    itype = np.int32 if indptr[-1] < 2**31 else np.int64
    indices = cols.to(torch.int32 if itype == np.int32 else torch.int64)
    adj = sp.csr_matrix(
        (np.ones(len(indices), np.float32), indices.cpu().numpy(),
         indptr.astype(itype)), shape=(n, n))
    adj.has_sorted_indices = True
    stats = {"n": n, "E": int(indptr[-1] // 2),
             "max_degree": int(deg.max())}
    return adj, stats
