"""Spectral (Laplacian-eigenvector) initialization, host side.

Counterpart of ``graphem_rapids_tpu/ops/laplacian.py``: symmetrize and
binarize the adjacency, take the normalized Laplacian, compute the (d+1)
smallest eigenvectors with ARPACK and drop the trivial one; on a solver
failure, warn and fall back to 0.1 * randn. Ported tiers: 'scipy' and
'random'. The device tiers 'chebyshev' and 'lobpcg' are not ported yet, so
'auto' raises from ``device_threshold`` vertices instead of quietly taking
the slow host solver there.
"""

import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
from scipy.sparse.csgraph import laplacian as _csgraph_laplacian

logger = logging.getLogger(__name__)


def _normalized_laplacian(adjacency):
    """Symmetrized, binarized normalized Laplacian."""
    if not sp.issparse(adjacency):
        adjacency = sp.csr_matrix(adjacency)
    A = sp.csr_matrix(adjacency + adjacency.transpose())
    A.data = np.ones_like(A.data)
    return _csgraph_laplacian(A, normed=True)


def _spectral_scipy(L, n_components, seed=None):
    k = n_components + 1
    # deterministic ARPACK start vector: the eigenvector signs (the
    # embedding's reflection class) are reproducible for a given seed
    v0 = np.random.default_rng(0 if seed is None else seed).standard_normal(
        L.shape[0]
    )
    _, eigenvectors = spla.eigsh(L, k, which="SM", v0=v0)
    return eigenvectors[:, 1:k]


def spectral_init(adjacency, n_components, method="auto", seed=None,
                  device_threshold=500_000):
    """Initial positions from the graph spectrum, (n, n_components) float32.

    method in {'auto', 'scipy', 'random'}; 'auto' is 'scipy' below
    ``device_threshold`` vertices. 'chebyshev' and 'lobpcg' (and 'auto'
    from the threshold on) raise NotImplementedError.
    """
    n = adjacency.shape[0]
    rng = np.random.default_rng(seed)

    if method == "random":
        return (rng.standard_normal((n, n_components)) * 0.1).astype(np.float32)
    if method == "auto":
        method = "scipy" if n < device_threshold else "chebyshev"
    if method in ("chebyshev", "lobpcg"):
        raise NotImplementedError(
            f"spectral init {method!r} is not ported yet (ROADMAP Queue 1, "
            f"spectral chebyshev/lobpcg); pass init='scipy' or init='random'"
            f" (n={n})"
        )
    if method != "scipy":
        raise ValueError(f"unknown spectral init method: {method!r}")

    L = _normalized_laplacian(adjacency)
    try:
        return _spectral_scipy(L, n_components, seed).astype(np.float32)
    except (ValueError, TypeError, RuntimeError, np.linalg.LinAlgError) as e:
        # ARPACK non-convergence (a RuntimeError), or a graph too small for
        # eigsh's k < n - 1 (TypeError/ValueError): the JAX package's own
        # warn-and-fall-back-to-random rule
        logger.warning("Eigendecomposition failed: %s", e)
        return (rng.standard_normal((n, n_components)) * 0.1).astype(np.float32)
