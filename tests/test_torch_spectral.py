"""The port's spectral tiers against the JAX package's, on the CPU.

Mirrors tests/test_spectral_chebyshev.py case by case. The matvec plan's
arrays must equal JAX's, and its SpMV must equal scipy's. The Chebyshev tier
starts from the same numpy block in both packages, so the port's subspace
must align with JAX's at >= 0.999 (the smallest canonical correlation) and
with host eigsh at > 0.95. Columns are compared modulo sign on the ER graph,
whose 4 lowest eigenvalues are well apart, at atol=1e-4: QR and eigh may
flip a column's sign between LAPACK builds, and rounding leaves gaps of
about 5.5e-6. LOBPCG
cannot share JAX's jax.random start, so it is held against eigsh only.
"""

import logging

import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphem_rapids_tpu as gr
from graphem_rapids_tpu.ops import laplacian as jlap
from graphem_rapids_torch import GraphEmbedderTorch, ShardedGraphEmbedder
from graphem_rapids_torch.ops import laplacian as lap

N = 2000
GRAPHS = {
    "regular": lambda: nx.random_regular_graph(8, N, seed=0),
    "er": lambda: nx.erdos_renyi_graph(N, 0.005, seed=0),
    "ba": lambda: nx.barabasi_albert_graph(N, 3, seed=0),
}


def _adj(G):
    return sp.csr_matrix(nx.adjacency_matrix(G, dtype=int))


def _subspace_alignment(X, Y):
    """Smallest canonical correlation between the column spans."""
    Qx, _ = np.linalg.qr(X)
    Qy, _ = np.linalg.qr(Y)
    return np.linalg.svd(Qx.T @ Qy, compute_uv=False).min()


def _assert_match_modulo_signs(X, Y, atol):
    for c in range(Y.shape[1]):
        d = min(np.abs(X[:, c] - Y[:, c]).max(),
                np.abs(X[:, c] + Y[:, c]).max())
        assert d < atol, f"column {c}: {d}"


def _star_path():
    """Hub degree 200 far above the table cap: the overflow path."""
    G = nx.star_graph(200)
    G.add_edges_from((i, i + 1) for i in range(1, 150))
    return _adj(G)


def _star_ring_chords():
    """tests/test_spectral_chebyshev.py's sharded overflow graph."""
    G = nx.star_graph(800)
    G.add_edges_from((i, (i + 1) % 801) for i in range(1, 800))
    G.add_edges_from((i, (i + 37) % 801) for i in range(1, 800))
    return _adj(G)


PLAN_CASES = {
    "star_path": (_star_path, None),
    "star_path_full_width": (_star_path, 201),
    "star_ring_chords": (
        lambda: sp.csr_matrix((_star_ring_chords() + _star_ring_chords().T
                               > 0).astype(np.float32)), None),
    "regular": (lambda: _adj(GRAPHS["regular"]()), None),
}


@pytest.mark.fast
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_matvec_plan_equals_jax(case):
    """The plan's arrays equal JAX's once JAX's self-pads (a row listed as
    its own neighbour, in the table and in the block plan's (hub, hub)
    pairs) are read as the zero row n."""
    make, cap = PLAN_CASES[case]
    A = make()
    want = jlap._adjacency_matvec_plan(A, cap=cap)
    got = lap._adjacency_matvec_plan(A, cap=cap)
    n = want["n"]
    assert got["n"] == n
    table = np.asarray(want["table"])
    table = np.where(table == np.arange(n)[:, None], n, table)
    np.testing.assert_array_equal(got["table"].numpy(), table)
    np.testing.assert_array_equal(
        (got["table"] == n).sum(dim=1).numpy(), np.asarray(want["pad_count"]))
    for key in ("overflow", "deg"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert (got["ov_plan"] is None) == (want["ov_plan"] is None)
    if want["ov_plan"] is not None:
        wov, gov = want["ov_plan"], got["ov_plan"]
        assert gov["block"] == wov["block"]
        pairs = np.asarray(wov["pairs"])
        nbr = np.where(pairs[:, 1] == pairs[:, 0], n, pairs[:, 1])
        np.testing.assert_array_equal(gov["nbr"].numpy(), nbr)
        for key in ("block_hub", "hub_ids"):
            np.testing.assert_array_equal(gov[key].numpy(),
                                          np.asarray(wov[key]))
        pads = (gov["nbr"] == n).float()
        hub_pads = torch.zeros(len(gov["hub_ids"])).index_add_(
            0, gov["block_hub"],
            pads.reshape(-1, gov["block"]).sum(dim=1))
        np.testing.assert_array_equal(hub_pads.numpy(),
                                      np.asarray(wov["pad_count"]))
    if case == "star_path":
        assert got["ov_plan"] is not None  # the hub spills into the plan
    if case == "star_path_full_width":
        assert got["ov_plan"] is None and got["overflow"].shape[0] == 0


@pytest.mark.fast
@pytest.mark.parametrize("cap", [None, 201])
def test_matvec_plan_matches_scipy_spmv(cap):
    """Table gather + overflow reproduce A @ X; the tolerance covers the
    fp32 summation order on the 200-degree hub row. Pads gather a zero row,
    so at the full width of 201 no row cancels 199 copies of itself."""
    A = _star_path()
    X = np.random.default_rng(0).standard_normal((A.shape[0], 4)).astype(
        np.float32)
    plan = lap._adjacency_matvec_plan(A, cap=cap)
    Y_ext = torch.from_numpy(np.concatenate([X, np.zeros((1, 4), X.dtype)]))
    AX = lap._overflow_correct(Y_ext[plan["table"]].sum(dim=1), Y_ext, plan)
    np.testing.assert_allclose(AX.numpy(), A @ X, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def cheb_results():
    """(port, JAX, eigsh) eigenvectors, k=3, seed 0, per graph."""
    out = {}
    for name, make in GRAPHS.items():
        A = _adj(make())
        out[name] = (
            lap._spectral_chebyshev(A, 3, seed=0),
            jlap._spectral_chebyshev(A, 3, seed=0),
            jlap._spectral_scipy(jlap._normalized_laplacian(A), 3, seed=0),
        )
    return out


@pytest.mark.fast
@pytest.mark.parametrize("gen", list(GRAPHS))
def test_chebyshev_matches_jax_and_eigsh(cheb_results, gen):
    port, ref, eigsh = cheb_results[gen]
    assert port.shape == (N, 3) and np.isfinite(port).all()
    assert _subspace_alignment(port, ref) >= 0.999
    assert _subspace_alignment(port, eigsh) > 0.95


@pytest.mark.fast
def test_chebyshev_columns_match_jax_modulo_sign(cheb_results):
    port, ref, _ = cheb_results["er"]
    _assert_match_modulo_signs(port, ref, atol=1e-4)


@pytest.mark.fast
def test_spectral_init_chebyshev_method():
    adj = gr.erdos_renyi_graph(500, 0.02, seed=0)
    X = lap.spectral_init(adj, 3, method="chebyshev", seed=0, device="cpu")
    assert X.shape == (500, 3)
    assert np.isfinite(X).all()
    assert X.dtype == np.float32


@pytest.mark.fast
@pytest.mark.parametrize("threshold,want", [(100, True), (10_000, False)])
def test_auto_routes_large_n_to_chebyshev(monkeypatch, threshold, want):
    adj = gr.erdos_renyi_graph(300, 0.05, seed=0)
    called = {}
    orig = lap._spectral_chebyshev

    def spy(*a, **kw):
        called["yes"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(lap, "_spectral_chebyshev", spy)
    lap.spectral_init(adj, 2, method="auto", seed=0, device="cpu",
                      device_threshold=threshold)
    assert called.get("yes", False) is want


@pytest.mark.fast
@pytest.mark.parametrize("method", ["chebyshev", "lobpcg"])
@pytest.mark.parametrize("error", [
    lap.SpectralDivergenceError("chebyshev subspace iteration diverged"),
    torch.linalg.LinAlgError("linalg.eigh: failed to converge"),
])
def test_device_tier_failure_tiers_down_to_scipy(monkeypatch, caplog, method,
                                                 error):
    """chebyshev/lobpcg -> scipy on the named divergence error and on
    LinAlgError, with the JAX package's warning text."""
    adj = gr.erdos_renyi_graph(200, 0.05, seed=0)

    def boom(*a, **kw):
        raise error

    monkeypatch.setattr(lap, "_spectral_" + method, boom)
    with caplog.at_level(logging.WARNING, logger=lap.logger.name):
        X = lap.spectral_init(adj, 2, method=method, seed=0, device="cpu")
    assert X.shape == (200, 2) and np.isfinite(X).all()
    # matches the scipy tier it fell back to
    Xs = jlap._spectral_scipy(jlap._normalized_laplacian(adj), 2, seed=0)
    assert _subspace_alignment(X, Xs) > 0.999
    want = ("Chebyshev subspace iteration failed" if method == "chebyshev"
            else "LOBPCG failed")
    assert [r.getMessage() for r in caplog.records] == [
        f"{want} ({error}); falling back to scipy eigsh"]


@pytest.mark.fast
@pytest.mark.parametrize("method", ["chebyshev", "lobpcg"])
@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.OutOfMemoryError("CUDA out of memory"),
])
def test_device_faults_do_not_tier_down(monkeypatch, caplog, method, error):
    """Any other error propagates: a device fault is never hidden behind a
    host eigsh."""
    adj = gr.erdos_renyi_graph(200, 0.05, seed=0)

    def boom(*a, **kw):
        raise error

    monkeypatch.setattr(lap, "_spectral_" + method, boom)
    with caplog.at_level(logging.WARNING, logger=lap.logger.name):
        with pytest.raises(type(error)):
            lap.spectral_init(adj, 2, method=method, seed=0, device="cpu")
    assert not caplog.records


@pytest.mark.fast
def test_divergence_is_detected(monkeypatch):
    """Non-finite Ritz values raise the named error (a NaN block)."""
    adj = gr.erdos_renyi_graph(200, 0.05, seed=0)
    orig = lap._cheb_iterate

    def nan_start(lap_mm, X0, v0, **kw):
        return orig(lap_mm, X0 * float("nan"), v0, **kw)

    monkeypatch.setattr(lap, "_cheb_iterate", nan_start)
    with pytest.raises((lap.SpectralDivergenceError,
                        torch.linalg.LinAlgError)):
        lap._spectral_chebyshev(adj, 2, seed=0)


@pytest.mark.fast
def test_lobpcg_aligns_with_eigsh(cheb_results):
    A = _adj(GRAPHS["regular"]())
    L = lap._normalized_laplacian(A)
    X = lap._spectral_lobpcg(L, 3, seed=0)
    assert X.shape == (N, 3) and np.isfinite(X).all()
    assert _subspace_alignment(X, cheb_results["regular"][2]) > 0.95


@pytest.mark.fast
def test_sharded_embedder_chebyshev_init():
    """ShardedGraphEmbedder routes init='chebyshev' through its mesh (one
    rank here; four in tests/test_torch_sharded.py) and the start aligns
    with host eigsh, equal to the single-card engine's."""
    adj = gr.generate_random_regular(n=1000, d=8, seed=0)
    kw = dict(n_components=3, seed=0, verbose=False, init="chebyshev",
              sample_size=64, device="cpu")
    emb = ShardedGraphEmbedder(adj, **kw)
    pos = emb.positions
    assert pos.shape == (1000, 3) and np.isfinite(pos).all()
    Xs = jlap._spectral_scipy(jlap._normalized_laplacian(adj), 3, seed=0)
    assert _subspace_alignment(pos, Xs) > 0.95
    np.testing.assert_array_equal(pos, GraphEmbedderTorch(adj, **kw).positions)


@pytest.mark.fast
def test_engine_default_init_at_threshold(monkeypatch):
    """GraphEmbedderTorch(adj) with init='auto' at n = 500,000 takes the
    Chebyshev tier on its device (a ring: a flat table of width 2) and
    runs."""
    n = 500_000
    i = np.arange(n)
    adj = sp.csr_matrix((np.ones(2 * n), (np.r_[i, (i + 1) % n],
                                          np.r_[(i + 1) % n, i])),
                        shape=(n, n))
    called = []
    orig = lap._spectral_chebyshev

    def spy(*a, **kw):
        called.append(kw["device"])
        return orig(*a, **kw)

    monkeypatch.setattr(lap, "_spectral_chebyshev", spy)
    emb = GraphEmbedderTorch(adj, n_components=2, device="cpu", seed=0,
                             verbose=False, sample_size=64)
    assert called == [torch.device("cpu")]
    pos = emb.run_layout(1)
    assert pos.shape == (n, 2) and np.isfinite(pos).all()
