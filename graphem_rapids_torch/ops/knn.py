"""k-nearest-neighbor search over edge midpoints.

Counterpart of ``graphem_rapids_tpu/ops/knn.py``. Strategies:

- ``knn_exact``   : one (S, E) distance matrix + ``torch.topk``.
- ``knn_chunked`` : a loop over ref tiles with a running top-k merge, so
                    the (S, E) matrix is never materialized.
- ``knn_approx``  : the JAX package's approx tier. There it is
                    ``jax.lax.approx_min_k``, which is a sort and a slice
                    on anything but a TPU; so here it is a one-shot (S, E)
                    distance matrix (refs padded to a multiple of 512 at
                    1e30, optionally in ``compute_dtype``) and one exact
                    ``torch.topk`` while the matrix fits
                    ``oneshot_budget_bytes``, and ``knn_chunked`` beyond.
                    Exact in float32; ``recall_target`` changes nothing.
- ``binfold``     : the fused bin-fold kernel (ops/knn_binfold.py).
- ``pallas``      : the exact tiled kNN kernel (ops/knn_pallas.py).

Distances are squared Euclidean, always in the difference form
(q - r)^2 summed over coordinates: the expanded |q|^2 - 2 q.r + |r|^2 form
loses close distances to fp32 cancellation (62% recall measured).
"""

import torch

from ..utils.memory_management import _platform_budget
from .knn_binfold import knn_binfold
from .knn_pallas import knn_pallas

# Below this many refs a single (S, E) distance matrix is cheap.
EXACT_MAX_REFS = 32768
DEFAULT_CHUNK = 8192
# Fraction of the device budget (a card's total memory) that the approx
# tier's one-shot pass may use, as in the JAX package.
ONESHOT_HBM_FRACTION = 0.5
# Peak device bytes of the one-shot pass per byte of its (S, E) float32
# matrix. XLA fuses the distances into the reduce; eager PyTorch holds the
# matrix and one coordinate's (S, E) difference at once: 2.0 by design,
# plus torch.topk's scratch; chip_smoke.py's approx phases print the
# measured factor (oneshot_peak_factor).
ONESHOT_PEAK_FACTOR = 2.01
# Test hook: when set, oneshot_budget_bytes() returns this value verbatim.
ONESHOT_BUDGET_OVERRIDE = None
# Ref counts of the one-shot pass are padded to a multiple of this, at
# REF_PAD, as in the JAX package.
ONESHOT_ROW_ALIGN = 512
REF_PAD = 1e30


def oneshot_budget_bytes(device=None):
    """Largest S*E*4 for which the approx tier takes the one-shot pass."""
    if ONESHOT_BUDGET_OVERRIDE is not None:
        return ONESHOT_BUDGET_OVERRIDE
    return int(_platform_budget(device) * ONESHOT_HBM_FRACTION
               / ONESHOT_PEAK_FACTOR)


def squared_distances(queries, refs):
    """(S, E) squared Euclidean distances, coordinate by coordinate.

    Summed in place from coordinate 0 on, so that at most one coordinate's
    (S, E) difference lives beside the result.
    """
    d2 = None
    for c in range(queries.shape[1]):
        diff = queries[:, c:c + 1] - refs[:, c]
        diff.mul_(diff)
        if d2 is None:
            d2 = diff
        else:
            d2.add_(diff)
            del diff
    if d2 is None:
        d2 = torch.zeros((queries.shape[0], refs.shape[0]),
                         dtype=queries.dtype, device=queries.device)
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


def _oneshot_approx(queries, refs, k, compute_dtype=None, recall_target=0.95):
    """One-shot distances to the refs padded to ONESHOT_ROW_ALIGN rows at
    REF_PAD, in ``compute_dtype`` when given, then one exact top-k.

    Returns (indices (S, k) int32, sq_distances (S, k) float32).
    ``recall_target`` is accepted as in the JAX package, where it tunes
    the TPU's PartialReduce; the top-k here is exact.
    """
    del recall_target
    E, d = refs.shape
    E_pad = -(-E // ONESHOT_ROW_ALIGN) * ONESHOT_ROW_ALIGN
    if E_pad != E:
        refs = torch.cat([refs, refs.new_full((E_pad - E, d), REF_PAD)])
    if compute_dtype is not None:
        queries = queries.to(compute_dtype)
        refs = refs.to(compute_dtype)
    vals, idx = torch.topk(squared_distances(queries, refs), k, dim=1,
                           largest=False, sorted=True)
    return idx.to(torch.int32), vals.to(torch.float32)


def knn_approx(queries, refs, k, chunk_size=DEFAULT_CHUNK,
               compute_dtype=None, recall_target=0.95):
    """The approx tier: ``_oneshot_approx`` while S*E*4 fits
    ``oneshot_budget_bytes``, else the exact blockwise scan.

    As in the JAX package, the scan computes in the inputs' dtype (its
    ``_knn_scanned`` takes no compute dtype) and returns float32 values.
    """
    S, E = queries.shape[0], refs.shape[0]
    if S * E * 4 <= oneshot_budget_bytes(queries.device):
        return _oneshot_approx(queries, refs, int(k),
                               compute_dtype=compute_dtype,
                               recall_target=recall_target)
    idx, vals = knn_chunked(queries, refs, int(k), min(chunk_size, E))
    return idx, vals.to(torch.float32)


def knn(queries, refs, k, strategy="auto", chunk_size=DEFAULT_CHUNK,
        compute_dtype=None, recall_target=0.95):
    """Strategy-dispatched kNN.

    strategy in {'auto', 'exact', 'chunked', 'approx', 'binfold',
    'pallas'}; 'auto' takes 'exact' up to EXACT_MAX_REFS refs, beyond that
    'approx' for CUDA tensors and 'chunked' on the CPU, as the JAX package
    does off and on its CPU. ``compute_dtype`` applies to 'approx' only.
    """
    if strategy == "auto":
        if refs.shape[0] <= EXACT_MAX_REFS:
            strategy = "exact"
        elif refs.is_cuda:
            strategy = "approx"
        else:
            strategy = "chunked"
    if strategy == "exact":
        return knn_exact(queries, refs, k)
    if strategy == "chunked":
        return knn_chunked(queries, refs, k, chunk_size)
    if strategy == "approx":
        return knn_approx(queries, refs, k, chunk_size,
                          compute_dtype=compute_dtype,
                          recall_target=recall_target)
    if strategy == "binfold":
        return knn_binfold(queries, refs, k, recall_target=recall_target)
    if strategy == "pallas":
        return knn_pallas(queries, refs, k)
    raise ValueError(f"Unknown kNN strategy: {strategy!r}")
