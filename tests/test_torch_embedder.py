"""GraphEmbedderTorch (on the CPU) against GraphEmbedderTPU.

Both engines start from the same positions (set through the ``positions``
setter) and take the same injected sample indices, so their trajectories
must agree: after 5 steps at rtol=1e-4, atol=1e-5, after 20 steps at the
JAX suite's own multi-step tolerance rtol=5e-3, atol=5e-4
(tests/test_oracle_parity.py). The summation order of the force scatters
differs between the packages, so the agreement is allclose, not bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphem_rapids_tpu as gr
from graphem_rapids_tpu.ops.laplacian import spectral_init as j_spectral_init
from graphem_rapids_torch import GraphEmbedderTorch, state_from_jax
from graphem_rapids_torch.models import oracle
from graphem_rapids_torch.ops.laplacian import spectral_init as t_spectral_init

PARAMS = dict(L_min=10.0, k_attr=0.5, k_inter=0.1, n_neighbors=5)


def _skewed_adj(n=400, seed=2):
    """The hub graph of tests/test_binned_table.py."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 300)] + [(1, j) for j in range(2, 200)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (700, 2)) if a != b]
    e = np.unique(np.array(sorted(set(e)), np.int64), axis=0)
    adj = sp.coo_matrix(
        (np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n)
    ).tocsr()
    adj = adj + adj.T
    adj.data[:] = 1
    return adj


CONFIGS = {
    # name: (adjacency maker, engine kwargs, expected table, strategy, fused)
    "flat_exact": (lambda: gr.generate_random_regular(n=300, d=6, seed=0),
                   dict(), "flat", "exact", False),
    "binned_exact": (_skewed_adj, dict(binned_table=True),
                     "binned+overflow plan", "exact", False),
    "flat_overflow_plan": (_skewed_adj, dict(binned_table=False),
                           "flat+overflow plan", "exact", False),
    "fused_binfold": (lambda: gr.generate_random_regular(n=300, d=6, seed=1),
                      dict(knn_strategy="binfold"), "flat", "binfold", True),
    "binned_fused_binfold": (_skewed_adj,
                             dict(knn_strategy="binfold", binned_table=True),
                             "binned+overflow plan", "binfold", True),
    "pallas": (lambda: gr.generate_random_regular(n=300, d=6, seed=2),
               dict(knn_strategy="pallas"), "flat", "pallas", False),
    # fused refs: the table's 1e30 pad slots reach the exact kernel
    "fused_pallas": (_skewed_adj,
                     dict(knn_strategy="pallas", fused_midpoints=True,
                          binned_table=True),
                     "binned+overflow plan", "pallas", True),
    # the approx tier off a TPU: one-shot distances and an exact top-k
    "approx": (lambda: gr.generate_random_regular(n=300, d=6, seed=3),
               dict(knn_strategy="approx", fused_midpoints=False), "flat",
               "approx", False),
    # fused by the auto rule for 'approx' (one-shot budget, 4E slots)
    "fused_approx": (_skewed_adj,
                     dict(knn_strategy="approx", binned_table=True),
                     "binned+overflow plan", "approx", True),
    # slot-major tables: K1 sees the refs in JAX's slot order
    "slot_fused_binfold": (lambda: gr.generate_random_regular(n=300, d=6,
                                                              seed=4),
                           dict(knn_strategy="binfold", ref_order="slot"),
                           "flat", "binfold", True),
    "slot_binned_fused_binfold": (_skewed_adj,
                                  dict(knn_strategy="binfold",
                                       ref_order="slot", binned_table=True),
                                  "binned+overflow plan", "binfold", True),
}


def _pair(name, sample_size=64, seed=7):
    make_adj, kw, table, strategy, fused = CONFIGS[name]
    adj = make_adj()
    common = dict(n_components=3, seed=seed, verbose=False,
                  sample_size=sample_size, init="random", **PARAMS, **kw)
    ref = gr.GraphEmbedderTPU(adj, **common)
    port = GraphEmbedderTorch(adj, device="cpu", **common)
    assert port.table_kind == table, port.table_kind
    assert port._strategy == strategy
    assert port._fused_refs_active is fused is ref._fused_refs_active
    assert ("buckets" in port._nb) == ("buckets" in ref._nb)
    assert port.ref_order == ref.ref_order
    start = np.random.default_rng(seed).standard_normal(
        (port.n, 3)).astype(np.float32)
    ref.positions = start
    port.positions = start
    return ref, port


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trajectory_matches_jax(name):
    ref, port = _pair(name)
    rng = np.random.default_rng(3)
    for step in range(1, 21):
        sampled = rng.permutation(ref.n_edges)[:64]
        ref.update_positions(sample_indices=sampled)
        port.update_positions(sample_indices=sampled)
        if step == 5:
            np.testing.assert_allclose(port.positions, ref.positions,
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.positions, ref.positions,
                               rtol=5e-3, atol=5e-4)
    assert port._iteration == ref._iteration == 20


@pytest.mark.fast
@pytest.mark.parametrize("name", ["flat_exact", "binned_exact"])
def test_one_step_matches_oracle(name):
    _, port = _pair(name)
    positions = port.positions.copy()
    sampled = np.random.default_rng(4).permutation(port.n_edges)[:64]
    expected = oracle.update_step_np(
        positions.astype(np.float64), port._edges_np, sampled, **PARAMS
    )
    port.update_positions(sample_indices=sampled)
    np.testing.assert_allclose(port.positions, expected, rtol=1e-3, atol=1e-4)


@pytest.mark.fast
@pytest.mark.parametrize("binned", [False, True])
def test_jax_checkpoint_loads(tmp_path, binned):
    adj = _skewed_adj(seed=7)
    kw = dict(n_components=2, seed=3, verbose=False, binned_table=binned,
              init="random")
    ref = gr.GraphEmbedderTPU(adj, **kw)
    ref.run_layout(num_iterations=3)
    path = tmp_path / "jax_state.npz"
    ref.save_checkpoint(path)

    state = state_from_jax(path)
    assert set(state) == {"positions", "iteration", "n", "n_components",
                          "n_edges"}
    assert state["iteration"] == 3 and state["n_edges"] == ref.n_edges
    port = GraphEmbedderTorch(adj, device="cpu", **kw)
    port.load_checkpoint(path)
    np.testing.assert_array_equal(port.positions, ref.positions)
    assert port._iteration == 3
    port2 = GraphEmbedderTorch(adj, device="cpu", **kw)
    port2.load_checkpoint(state)
    np.testing.assert_array_equal(port2.positions, ref.positions)
    # the JAX key cannot carry over: both reseed to the same stream
    port.update_positions()
    port2.update_positions()
    np.testing.assert_array_equal(port.positions, port2.positions)

    wrong = GraphEmbedderTorch(adj, device="cpu", **{**kw, "n_components": 3})
    with pytest.raises(ValueError, match="n_components"):
        wrong.load_checkpoint(path)


@pytest.mark.fast
def test_own_checkpoint_resumes_exactly(tmp_path):
    adj = _skewed_adj(seed=5)
    kw = dict(n_components=2, seed=1, verbose=False, binned_table=True,
              init="random", sample_size=32)
    a = GraphEmbedderTorch(adj, device="cpu", **kw)
    a.run_layout(4, block_size=2)
    path = tmp_path / "torch_state.npz"
    a.save_checkpoint(path)
    b = GraphEmbedderTorch(adj, device="cpu", **{**kw, "seed": 99})
    b.load_checkpoint(path)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.run_layout(3), b.run_layout(3))


@pytest.mark.fast
def test_run_layout_and_edge_cases():
    adj = gr.erdos_renyi_graph(120, 0.05, seed=2)
    emb = GraphEmbedderTorch(adj, device="cpu", seed=0, verbose=False,
                             n_components=3)
    pos = emb.run_layout(5, block_size=2)
    assert pos.shape == (120, 3) and np.isfinite(pos).all()
    np.testing.assert_allclose(pos.std(axis=0, ddof=1), 1.0, atol=1e-4)
    assert emb._iteration == 5
    with pytest.raises(ValueError, match="block_size"):
        emb.run_layout(2, block_size=0)
    slot = GraphEmbedderTorch(adj, device="cpu", verbose=False, seed=0,
                              n_components=3, ref_order="slot")
    assert slot.ref_order == "slot" and slot._nb["ref_order"] == "slot"
    assert "table_t" in slot._nb and "table" not in slot._nb
    spos = slot.run_layout(5, block_size=2)
    assert spos.shape == (120, 3) and np.isfinite(spos).all()
    with pytest.raises(ValueError, match="ref_order"):
        GraphEmbedderTorch(adj, device="cpu", verbose=False, ref_order="col")
    with pytest.raises(ValueError, match="square"):
        GraphEmbedderTorch(np.ones((2, 3)), device="cpu", verbose=False)
    with pytest.raises(ValueError, match="n_neighbors"):
        GraphEmbedderTorch(adj, device="cpu", verbose=False, n_neighbors=0)
    one_edge = sp.csr_matrix(np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]]))
    e1 = GraphEmbedderTorch(one_edge, device="cpu", verbose=False,
                            init="random", seed=0)
    assert np.isfinite(e1.run_layout(2)).all()
    empty = GraphEmbedderTorch(sp.csr_matrix((4, 4)), device="cpu",
                               verbose=False, init="random", seed=0)
    np.testing.assert_array_equal(empty.run_layout(2), empty.positions)


@pytest.mark.fast
def test_auto_strategy_gates(monkeypatch):
    adj = gr.erdos_renyi_graph(200, 0.1, seed=0)
    emb = GraphEmbedderTorch(adj, device="cpu", verbose=False, seed=0)
    assert emb._resolved_strategy() == "exact"
    monkeypatch.setattr(emb, "n_edges", 100_000)  # past the exact tier
    assert emb._resolved_strategy() == "chunked"  # the CPU
    monkeypatch.setattr(emb, "device", torch.device("cuda"))
    assert emb._resolved_strategy() == "binfold"
    # outside the bin-fold gates CUDA takes 'approx', as JAX does
    monkeypatch.setattr(emb, "n_components", 9)  # dimension gate
    assert emb._resolved_strategy() == "approx"
    monkeypatch.setattr(emb, "n_components", 3)
    monkeypatch.setattr(emb, "n_neighbors", 48)  # k+1 > MAX_K
    assert emb._resolved_strategy() == "approx"
    monkeypatch.setattr(emb, "n_neighbors", 10)
    monkeypatch.setattr(emb, "n_edges", 1 << 28)  # past MAX_REFS_SEGMENTED
    assert emb._resolved_strategy() == "approx"


@pytest.mark.fast
def test_spectral_init_tiers_match_jax():
    adj = gr.erdos_renyi_graph(150, 0.06, seed=3)
    for method in ("scipy", "random"):
        np.testing.assert_array_equal(
            t_spectral_init(adj, 3, method=method, seed=4),
            j_spectral_init(adj, 3, method=method, seed=4),
        )
    # eigsh cannot take k >= n - 1: both fall back to the same 0.1*randn
    k4 = sp.csr_matrix(np.ones((4, 4)) - np.eye(4))
    np.testing.assert_array_equal(t_spectral_init(k4, 3, method="scipy", seed=1),
                                  j_spectral_init(k4, 3, method="scipy", seed=1))
    # the device tiers: Chebyshev from the JAX tier's start block spans
    # the same subspace; 'auto' from the threshold on is that tier;
    # LOBPCG (another start) spans eigsh's; without a card and without
    # device='cpu' they raise instead of tiering down
    cheb = t_spectral_init(adj, 3, method="chebyshev", seed=4, device="cpu")
    assert cheb.dtype == np.float32 and cheb.shape == (150, 3)
    assert _alignment(cheb, j_spectral_init(adj, 3, method="chebyshev",
                                            seed=4)) > 0.999
    np.testing.assert_array_equal(
        t_spectral_init(adj, 3, method="auto", seed=4, device="cpu",
                        device_threshold=100), cheb)
    eigsh = j_spectral_init(adj, 3, method="scipy", seed=4)
    assert _alignment(t_spectral_init(adj, 3, method="lobpcg", seed=4,
                                      device="cpu"), eigsh) > 0.95
    if not torch.cuda.is_available():
        for method in ("chebyshev", "lobpcg"):
            with pytest.raises(RuntimeError, match="CUDA"):
                t_spectral_init(adj, 3, method=method)


def _alignment(X, Y):
    """Smallest canonical correlation between the column spans."""
    return np.linalg.svd(np.linalg.qr(X)[0].T @ np.linalg.qr(Y)[0],
                         compute_uv=False).min()
