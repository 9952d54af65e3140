"""k-nearest-neighbor search over edge midpoints.

Counterpart of ``graphem_rapids_tpu/ops/knn.py``. Strategies:

- ``knn_exact``   : one (S, E) distance matrix + ``torch.topk``.
- ``knn_chunked`` : a loop over ref tiles with a running top-k merge, so
                    the (S, E) matrix is never materialized.
- ``binfold``     : the fused bin-fold kernel (ops/knn_binfold.py).
- ``pallas``      : the exact tiled kNN kernel (ops/knn_pallas.py).

Distances are squared Euclidean, always in the difference form
(q - r)^2 summed over coordinates: the expanded |q|^2 - 2 q.r + |r|^2 form
loses close distances to fp32 cancellation (62% recall measured).
"""

import torch

from .knn_binfold import knn_binfold
from .knn_pallas import knn_pallas

# Below this many refs a single (S, E) distance matrix is cheap.
EXACT_MAX_REFS = 32768
DEFAULT_CHUNK = 8192


def squared_distances(queries, refs):
    """(S, E) squared Euclidean distances, coordinate by coordinate."""
    d2 = torch.zeros((queries.shape[0], refs.shape[0]), dtype=queries.dtype,
                     device=queries.device)
    for c in range(queries.shape[1]):
        diff = queries[:, c:c + 1] - refs[:, c]
        d2 = d2 + diff * diff
    return d2


def knn_exact(queries, refs, k):
    """Exact kNN: (indices (S, k) int32, sq_distances (S, k))."""
    vals, idx = torch.topk(squared_distances(queries, refs), k, dim=1,
                           largest=False, sorted=True)
    return idx.to(torch.int32), vals


def knn_chunked(queries, refs, k, chunk_size=DEFAULT_CHUNK):
    """Exact kNN over ref tiles of ``chunk_size`` with a running top-k."""
    E = refs.shape[0]
    vals = idx = None
    for lo in range(0, E, chunk_size):
        d2 = squared_distances(queries, refs[lo:lo + chunk_size])
        c_vals, c_idx = torch.topk(d2, min(k, d2.shape[1]), dim=1,
                                   largest=False, sorted=True)
        c_idx = c_idx + lo
        if vals is not None:
            c_vals = torch.cat([vals, c_vals], dim=1)
            c_idx = torch.cat([idx, c_idx], dim=1)
            c_vals, pos = torch.topk(c_vals, min(k, c_vals.shape[1]), dim=1,
                                     largest=False, sorted=True)
            c_idx = torch.gather(c_idx, 1, pos)
        vals, idx = c_vals, c_idx
    return idx.to(torch.int32), vals


def knn(queries, refs, k, strategy="auto", chunk_size=DEFAULT_CHUNK,
        recall_target=0.95):
    """Strategy-dispatched kNN.

    strategy in {'auto', 'exact', 'chunked', 'binfold', 'pallas'}; 'auto'
    takes 'exact' up to EXACT_MAX_REFS refs and 'chunked' beyond. 'approx'
    is not ported yet and raises NotImplementedError.
    """
    if strategy == "auto":
        strategy = "exact" if refs.shape[0] <= EXACT_MAX_REFS else "chunked"
    if strategy == "exact":
        return knn_exact(queries, refs, k)
    if strategy == "chunked":
        return knn_chunked(queries, refs, k, chunk_size)
    if strategy == "binfold":
        return knn_binfold(queries, refs, k, recall_target=recall_target)
    if strategy == "approx":
        raise NotImplementedError(
            "the 'approx' kNN strategy is not ported yet (ROADMAP Queue 1, "
            "'the approx strategy'); use 'binfold' or 'chunked'"
        )
    if strategy == "pallas":
        return knn_pallas(queries, refs, k)
    raise ValueError(f"Unknown kNN strategy: {strategy!r}")
