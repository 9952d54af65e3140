"""Spectral (Laplacian-eigenvector) initialization.

Counterpart of ``graphem_rapids_tpu/ops/laplacian.py``: symmetrize and
binarize the adjacency, take the normalized Laplacian, compute its (d+1)
smallest eigenvectors and drop the trivial one. Four tiers:

- 'scipy'    : host ARPACK eigsh.
- 'chebyshev': Chebyshev-filtered subspace iteration on the device. The
  SpMV is the dense neighbour-table gather + row-sum of the spring pass,
  its pads pointed at an appended zero row, with the hub overflow folded in
  blocks; the null vector
  D^{1/2}1 is deflated analytically and the filter damps the bulk [a, 2],
  so no preconditioner is needed. With a mesh of several ranks the table
  is row-sharded: each rank gathers its rows and one tiled all_gather per
  matvec assembles A @ X; the rest stays replicated.
- 'lobpcg'   : ``torch.lobpcg`` on the sparse 2I - L, an explicit opt-in.
- 'random'   : 0.1 * randn.

'auto' is 'scipy' below ``device_threshold`` vertices and 'chebyshev' from
it on. Failures tier down chebyshev/lobpcg -> scipy -> random, as in the JAX
package, with one deliberate difference: a device tier tiers down only on
``SpectralDivergenceError`` and ``torch.linalg.LinAlgError``. Any other error
(a CUDA fault, an out-of-memory) propagates, so a device fault never hides
behind a slow host eigsh.
"""

import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from scipy.sparse.csgraph import laplacian as _csgraph_laplacian

from ..utils import tracing
from .forces import _optimal_table_cap, build_overflow_plan
from .segment import segment_sum_sorted

logger = logging.getLogger(__name__)


class SpectralDivergenceError(RuntimeError):
    """A device eigensolver produced non-finite Ritz values."""


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


def _adjacency_matvec_plan(A, cap=None, device="cpu"):
    """The gather-SpMV plan of A, with every pad pointed at row n.

    Built on the host with the spring table's cost model and overflow plan
    (``_optimal_table_cap``, ``build_overflow_plan``), then uploaded to
    ``device``, ids as int64 (the port's gather index type). The SpMV
    gathers from [Y; 0], so a pad adds exactly 0. (The JAX plan pads with
    the row's own id, gathers copies of the row and subtracts pad_count
    times it, which cancels hundreds of float32 copies on a wide row; its
    arrays equal these once its self-pads are read as n.) Keys: 'table'
    (n, cap) neighbour ids, 'overflow' (O, 2) COO tail, rows ascending
    (empty when the block plan takes it), 'ov_plan' the hub block-fold plan
    or None ('nbr' (O',) neighbour ids, 'block_hub', 'hub_ids', 'block' an
    int), 'deg' (n,) float32, 'n'.
    """
    n = A.shape[0]
    A = A.tocsr()
    deg = np.diff(A.indptr)
    if cap is None:
        cap = _optimal_table_cap(deg, n) if n else 1
    cap = max(cap, 1)

    src = np.repeat(np.arange(n), deg)
    dst = A.indices.astype(np.int64)
    col = np.arange(len(src)) - A.indptr[src]
    in_table = col < cap
    table = np.full((n, cap), n, dtype=np.int64)
    table[src[in_table], col[in_table]] = dst[in_table]
    overflow = np.column_stack([src[~in_table], dst[~in_table]]).astype(
        np.int64
    )
    ov_plan = build_overflow_plan(overflow)
    if ov_plan is not None:
        overflow = np.zeros((0, 2), np.int64)
        # the adjacency has no self-loops: a (hub, hub) pair is a pad
        hub, nbr = ov_plan["pairs"][:, 0], ov_plan["pairs"][:, 1]
        ov_plan = {
            "nbr": np.where(nbr == hub, n, nbr),
            "block_hub": ov_plan["block_hub"],
            "hub_ids": ov_plan["hub_ids"],
            "block": ov_plan["block"],
        }

    def put(a):
        t = torch.as_tensor(a, device=device)
        return t.long() if a.dtype.kind in "iu" else t

    return {
        "table": put(table),
        "overflow": put(overflow),
        "ov_plan": None if ov_plan is None else {
            k: (v if k == "block" else put(v)) for k, v in ov_plan.items()
        },
        "deg": put(deg.astype(np.float32)),
        "n": n,
    }


def _overflow_correct(AY, Y_ext, plan):
    """Fold the block-plan / COO overflow into the gathered A @ Y, from
    Y_ext = [Y; 0]: dense per-block sums scattered onto the H hub rows, or
    the COO tail scattered onto its rows, each row's terms in order
    (``segment_sum_sorted``: the plan's block_hub and COO rows ascend)."""
    ov = plan["ov_plan"]
    if ov is not None:
        s = Y_ext.shape[1]
        blk = Y_ext[ov["nbr"]].reshape(-1, ov["block"], s).sum(dim=1)
        hub = torch.zeros((ov["hub_ids"].shape[0], s), dtype=Y_ext.dtype,
                          device=Y_ext.device)
        segment_sum_sorted(hub, ov["block_hub"], blk)
        # hub_ids are distinct: one term per row, no order to fix
        return AY.index_add_(0, ov["hub_ids"], hub)
    overflow = plan["overflow"]
    if overflow.shape[0] > 0:
        return segment_sum_sorted(AY, overflow[:, 0], Y_ext[overflow[:, 1]])
    return AY


def _cheb_iterate(lap_mm, X0, v0, *, k, degree, n_outer):
    """Chebyshev-filtered subspace iteration over an abstract L @ X.

    Shared by the single-device and row-sharded runners; only the SpMV
    differs. The cutoff ``a`` and the Ritz values stay on the device, so
    the loop reads nothing back to the host. Returns (X, last Ritz values).
    """

    def deflate(X):
        return X - v0[:, None] * (v0 @ X)

    def cheb_filter(X, a):
        """T_degree of L mapped so [a, 2] -> [-1, 1]."""
        e = (2.0 + a) / 2.0
        c = (2.0 - a) / 2.0
        Y_prev = X
        Y = (lap_mm(X) - e * X) / c
        for _ in range(degree - 1):
            Y_next = (2.0 / c) * (lap_mm(Y) - e * Y) - Y_prev
            Y_prev, Y = Y, Y_next
        return Y

    X = X0
    a = torch.tensor(0.5, dtype=X0.dtype, device=X0.device)
    ritz = None
    for _ in range(n_outer):
        X = cheb_filter(X, a)
        X = deflate(X)
        X, _ = torch.linalg.qr(X)
        H = X.T @ lap_mm(X)
        ritz, W = torch.linalg.eigh((H + H.T) / 2.0)
        X = X @ W
        a = torch.clamp(ritz[k], 0.05, 1.9)
    return X, ritz


def _build_lap_mm(plan, dinv, s, mesh=None):
    """L @ X for (n, s) blocks: X - dinv * (A @ (dinv * X)).

    A @ Y is the dense table gather + row-sum, then the overflow; no
    scatter but the overflow's. With a mesh of several ranks the table is
    row-sharded: rank r gathers rows [r * n_loc, (r + 1) * n_loc), the tail
    rank's pad rows gather only the zero row, and one tiled all_gather per
    matvec assembles A @ Y (its pad rows dropped by [:n]); the overflow,
    the elementwise work, QR and eigh stay replicated.
    """
    n = plan["n"]
    table = plan["table"]
    sharded = mesh is not None and mesh.world_size > 1
    if sharded:
        n_loc = (n + mesh.world_size - 1) // mesh.world_size
        lo = min(mesh.rank * n_loc, n)
        hi = min(lo + n_loc, n)
        rows = torch.full((n_loc, table.shape[1]), n, dtype=table.dtype,
                          device=table.device)
        rows[:hi - lo] = table[lo:hi]
        table = rows
    Y_ext = torch.zeros((n + 1, s), dtype=dinv.dtype, device=dinv.device)

    def lap_mm(X):
        tracing.count("chebyshev.matvecs")
        torch.mul(dinv[:, None], X, out=Y_ext[:n])
        AY = Y_ext[table].sum(dim=1)
        if sharded:
            AY = mesh.all_gather_tiled(AY)[:n]
        AY = _overflow_correct(AY, Y_ext, plan)
        return X - dinv[:, None] * AY

    return lap_mm


def _spectral_chebyshev(adjacency, n_components, seed, n_outer=8,
                        degree=14, guard=4, mesh=None, device="cpu"):
    """Chebyshev-filtered subspace iteration for the low end of L, on
    ``device``; (n, n_components) float32 numpy.

    ``s = n_components + 1 + guard`` columns: the wanted vectors, deflation
    slack and a guard block. The start block comes from
    ``np.random.default_rng(seed)`` in float32, as in the JAX package, so
    both start from the same block. Each outer round runs the degree-
    ``degree`` filter, deflates v0 = D^{1/2}1/|.|, orthonormalizes (QR) and
    applies Rayleigh-Ritz (eigh of the symmetrized s x s block); the cutoff
    adapts to the first guard Ritz value. Raises SpectralDivergenceError if
    a Ritz value is not finite. With a mesh of several ranks the SpMV is
    row-sharded (``_build_lap_mm``), and the mesh's device is used.
    """
    n = adjacency.shape[0]
    k = n_components
    s = k + 1 + guard
    if n <= k:
        raise ValueError(
            f"chebyshev needs n > n_components, got n={n}, n_components={k}"
        )
    sharded = mesh is not None and mesh.world_size > 1
    if sharded:
        device = mesh.device

    with tracing.span("spectral.plan") as planned:
        if not sp.issparse(adjacency):
            adjacency = sp.csr_matrix(adjacency)
        A = sp.csr_matrix(adjacency + adjacency.transpose())
        A.data = np.ones_like(A.data)
        A.setdiag(0)
        A.eliminate_zeros()
        plan = _adjacency_matvec_plan(A, device=device)

        deg = plan["deg"]
        dinv = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
        sqrt_deg = torch.sqrt(deg)
        # L v0 = 0
        v0 = sqrt_deg / (torch.linalg.vector_norm(sqrt_deg) + 1e-30)

        rng = np.random.default_rng(0 if seed is None else seed)
        X0 = torch.as_tensor(rng.standard_normal((n, s)).astype(np.float32),
                             device=device)
    with tracing.span("spectral.iterate") as iterated:
        lap_mm = _build_lap_mm(plan, dinv, s, mesh=mesh)
        X, ritz = _cheb_iterate(lap_mm, X0, v0, k=k, degree=degree,
                                n_outer=n_outer)
        ritz = ritz.cpu().numpy()
        X = X[:, :k].cpu().numpy()
    seconds = planned.seconds + iterated.seconds
    if not np.all(np.isfinite(ritz)):
        raise SpectralDivergenceError("chebyshev subspace iteration diverged")
    if plan["ov_plan"] is not None:
        overflow = ("block", int(plan["ov_plan"]["nbr"].shape[0]))
    else:
        overflow = ("coo" if plan["overflow"].shape[0] else "none",
                    int(plan["overflow"].shape[0]))
    logger.info(
        "chebyshev: n=%d, %d columns, %d matvecs on %s, table cap %d, "
        "overflow %s (%d pairs), %.3f s with the host plan; ritz %s",
        n, s, n_outer * (degree + 1), device, plan["table"].shape[1],
        *overflow, seconds, ritz.tolist(),
        extra={"chebyshev_seconds": seconds, "ritz": ritz.tolist(),
               "overflow": overflow[0], "overflow_pairs": overflow[1]},
    )
    # deflation removed the trivial vector; columns are Ritz-ordered
    # ascending, so the first k are the wanted nontrivial eigenvectors
    return X


def _spectral_lobpcg(L, n_components, seed, device="cpu"):
    """LOBPCG on the sparse 2I - L (its largest eigenpairs are the smallest
    of L), float32 on ``device``, from a numpy-seeded start block."""
    n = L.shape[0]
    k = n_components + 1
    M = (2.0 * sp.identity(n, format="csr") - L).tocoo()
    idx = torch.as_tensor(np.stack([M.row, M.col]).astype(np.int64))
    B = torch.sparse_coo_tensor(
        idx, torch.as_tensor(M.data, dtype=torch.float32), (n, n),
        check_invariants=True,
    ).coalesce().to(device)
    rng = np.random.default_rng(0 if seed is None else seed)
    X0 = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32),
                         device=device)
    _, X = torch.lobpcg(B, k=k, X=X0, niter=200, largest=True)
    return X[:, 1:k].cpu().numpy()


def spectral_init(adjacency, n_components, method="auto", seed=None,
                  device_threshold=500_000, mesh=None, device=None):
    """Initial positions from the graph spectrum, (n, n_components) float32.

    method in {'auto', 'scipy', 'chebyshev', 'lobpcg', 'random'}; 'auto' is
    host ARPACK below ``device_threshold`` vertices and the device Chebyshev
    tier from it on. ``device`` is where the device tiers run: None means
    the mesh's device when a mesh is given, else the CUDA card, which must
    exist unless 'cpu' is passed. ``mesh``: a mesh of several ranks
    row-shards the Chebyshev SpMV over its ranks.
    """
    n = adjacency.shape[0]
    rng = np.random.default_rng(seed)

    if method == "random":
        return (rng.standard_normal((n, n_components)) * 0.1).astype(np.float32)
    if method == "auto":
        method = "scipy" if n < device_threshold else "chebyshev"
    if method not in ("scipy", "chebyshev", "lobpcg"):
        raise ValueError(f"unknown spectral init method: {method!r}")
    if method != "scipy":
        from ..models.embedder import resolve_device

        if device is None and mesh is not None:
            device = mesh.device
        device = resolve_device(device)

    if method == "chebyshev":
        try:
            return _spectral_chebyshev(
                adjacency, n_components, seed, mesh=mesh, device=device
            ).astype(np.float32)
        except (SpectralDivergenceError, torch.linalg.LinAlgError) as e:
            logger.warning(
                "Chebyshev subspace iteration failed (%s); "
                "falling back to scipy eigsh", e,
            )
            method = "scipy"

    L = _normalized_laplacian(adjacency)
    if method == "lobpcg":
        try:
            return _spectral_lobpcg(L, n_components, seed,
                                    device=device).astype(np.float32)
        except (SpectralDivergenceError, torch.linalg.LinAlgError) as e:
            logger.warning("LOBPCG failed (%s); falling back to scipy eigsh", e)

    try:
        return _spectral_scipy(L, n_components, seed).astype(np.float32)
    except (ValueError, TypeError, RuntimeError, np.linalg.LinAlgError) as e:
        # ARPACK non-convergence (a RuntimeError), or a graph too small for
        # eigsh's k < n - 1 (TypeError/ValueError): the JAX package's own
        # warn-and-fall-back-to-random rule
        logger.warning("Eigendecomposition failed: %s", e)
        return (rng.standard_normal((n, n_components)) * 0.1).astype(np.float32)
