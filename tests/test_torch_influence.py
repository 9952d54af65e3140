"""Influence maximization and the IC simulator of the PyTorch port against
the JAX package.

The two simulators draw their coins from different generators, so spreads
agree in distribution, not run by run. The gates are therefore:
- exact counts where the cascade is not random: p=0 leaves exactly the
  seeds active, p=1 activates exactly the seeds' connected components;
- at p=0.1, mean spreads of 512 runs a side within 4 standard errors of
  the difference (a false alarm about once in 16,000 runs);
- greedy seeds on a hub graph whose best seeds are far apart in gain
  (margins of several standard errors at 32 runs per estimate), held
  against the JAX full sweep ``_greedy_scatter`` and the JAX greedy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

import graphem_rapids_torch as grt
from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_sim as tic
from graphem_rapids_torch.ops.ic_cascade import pack_columns


def _adj(edges, n):
    e = np.asarray(edges, np.int64)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1
    return a


def _lt_edges(adj):
    rows, cols = adj.nonzero()
    mask = rows < cols
    return np.column_stack([rows[mask], cols[mask]]).astype(np.int64)


def _disconnected(seed=0):
    """A hub (vertex 0, 120 leaves, above any table cap) with a ring through
    its leaves, a separate ring 150..249, and isolated vertices 250..299."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 121)]
    e += [(j, j + 1) for j in range(1, 120)]
    e += [(150 + j, 150 + (j + 1) % 100) for j in range(100)]
    e += [tuple(sorted(p)) for p in rng.integers(150, 250, (30, 2))
          if p[0] != p[1]]
    return _adj(sorted(set(e)), 300)


def _sparse_random(n=400, m=900, seed=1):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e = e[e[:, 0] != e[:, 1]]
    return _adj(np.sort(e, axis=1), n)


def _hub_graph(seed=3):
    """Four stars of 80, 50, 30 and 15 leaves, disjoint, plus 30 random
    leaf-leaf edges: at p=0.2 the hubs' gains are far apart."""
    rng = np.random.default_rng(seed)
    e, nxt = [], 4
    for hub, leaves in enumerate((80, 50, 30, 15)):
        e += [(hub, nxt + j) for j in range(leaves)]
        nxt += leaves
    e += [tuple(sorted(p)) for p in rng.integers(4, nxt, (30, 2))
          if p[0] != p[1]]
    return _adj(sorted(set(e)), nxt)


def _component_size(adj, seeds):
    _, labels = connected_components(adj, directed=False)
    hit = np.isin(labels, labels[np.asarray(seeds)])
    return int(hit.sum())


@pytest.fixture(params=["table", "scatter"])
def path(request, monkeypatch):
    if request.param == "scatter":
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    return request.param


@pytest.mark.fast
@pytest.mark.parametrize("seeds", [[5], [5, 200], [260], [0, 160, 299]])
def test_p0_and_p1_are_exact(path, seeds):
    adj = _disconnected()
    edges, n = _lt_edges(adj), adj.shape[0]
    plan = tic.build_cascade_plan(edges, n, "cpu")
    if path == "table":
        assert plan is not None and plan["ov_dst"].numel() > 0  # hub overflow
    else:
        assert plan is None
    c0, iters = tic.independent_cascade(edges, n, seeds, p=0.0, num_sims=16,
                                        device="cpu")
    assert iters == 200 and c0.shape == (16,)
    assert (c0 == len(seeds)).all()
    c1, _ = tic.independent_cascade(edges, n, seeds, p=1.0, num_sims=16,
                                    device="cpu")
    assert (c1 == _component_size(adj, seeds)).all()
    assert tinf.estimated_influence(adj, seeds, p=1.0, num_sims=4,
                                    device="cpu") == _component_size(adj, seeds)


@pytest.mark.fast
def test_all_seeds_and_depth_cap(path):
    adj = _disconnected()
    edges, n = _lt_edges(adj), adj.shape[0]
    counts, _ = tic.independent_cascade(edges, n, range(n), p=0.5,
                                        num_sims=8, device="cpu")
    assert (counts == n).all()
    # a ring walked at p=1 from one vertex gains two vertices per step
    ring = _adj([(j, (j + 1) % 60) for j in range(60)], 60)
    capped, _ = tic.independent_cascade(_lt_edges(ring), 60, [0], p=1.0,
                                        num_sims=2, max_iters=3,
                                        device="cpu")
    assert (capped == 7).all()


@pytest.mark.fast
def test_mean_spread_matches_jax(path):
    jic = pytest.importorskip("graphem_rapids_tpu.ops.ic_sim")
    jax = pytest.importorskip("jax")
    adj = _sparse_random()
    edges, n = _lt_edges(adj), adj.shape[0]
    seeds = [3, 77, 150, 301, 388]
    jc, _ = jic.independent_cascade(edges, n, seeds, p=0.1, num_sims=512,
                                    key=jax.random.PRNGKey(11))
    tc, _ = tic.independent_cascade(edges, n, seeds, p=0.1, num_sims=512,
                                    key=11, device="cpu")
    jc, tc = np.asarray(jc, float), np.asarray(tc, float)
    se = np.sqrt(jc.var(ddof=1) / len(jc) + tc.var(ddof=1) / len(tc))
    assert abs(jc.mean() - tc.mean()) < 4 * se, (jc.mean(), tc.mean(), se)
    assert tc.min() >= len(seeds)


@pytest.mark.fast
def test_keys_reproduce():
    adj = _sparse_random(seed=4)
    edges, n = _lt_edges(adj), adj.shape[0]
    a, _ = tic.independent_cascade(edges, n, [1, 2], num_sims=32, key=5,
                                   device="cpu")
    b, _ = tic.independent_cascade(edges, n, [1, 2], num_sims=32,
                                   key=torch.Generator().manual_seed(5),
                                   device="cpu")
    np.testing.assert_array_equal(a, b)


@pytest.mark.fast
def test_graphem_seed_selection_matches_jax():
    gr = pytest.importorskip("graphem_rapids_tpu")
    adj = _sparse_random(n=300, m=800, seed=6)
    kw = dict(n_components=3, seed=0, verbose=False, init="random")
    ref = gr.GraphEmbedderTPU(adj, **kw)
    port = grt.GraphEmbedderTorch(adj, device="cpu", **kw)
    start = np.random.default_rng(2).standard_normal((300, 3)).astype(
        np.float32)
    ref.positions = start
    port.positions = start
    want = gr.graphem_seed_selection(ref, k=12, num_iterations=0)
    got = grt.graphem_seed_selection(port, k=12, num_iterations=0)
    assert got == want and len(got) == 12


@pytest.mark.fast
def test_greedy_matches_jax_full_sweep():
    jax = pytest.importorskip("jax")
    jinf = pytest.importorskip("graphem_rapids_tpu.influence")
    adj = _hub_graph()
    edges, n = _lt_edges(adj), adj.shape[0]
    kw = dict(p=0.2, iterations_count=50, num_sims=32)
    want, _ = jinf._greedy_scatter(edges.astype(np.int32), n, 3, kw["p"],
                                   kw["iterations_count"], kw["num_sims"],
                                   jax.random.PRNGKey(0))
    assert want == [0, 1, 2]
    j_celf, _ = jinf.greedy_seed_selection((edges, n), 3, seed=0, **kw)
    assert j_celf == want
    got, evals = grt.greedy_seed_selection(adj, 3, seed=0, device="cpu", **kw)
    assert got == want and evals >= n * kw["num_sims"]


@pytest.mark.fast
def test_greedy_scatter_path_matches(monkeypatch):
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    adj = _hub_graph()
    got, evals = grt.greedy_seed_selection(adj, 3, p=0.2, iterations_count=50,
                                           num_sims=32, seed=1, device="cpu")
    assert got == [0, 1, 2]
    n = adj.shape[0]
    assert evals == (n + (n - 1) + (n - 2)) * 32  # a full sweep per round


@pytest.mark.fast
def test_ndlib_fallback_and_graph_inputs():
    nx = pytest.importorskip("networkx")
    jinf = pytest.importorskip("graphem_rapids_tpu.influence")
    adj = _disconnected()
    count, iters = grt.ndlib_estimated_influence(adj, [5], p=1.0,
                                                 iterations_count=150,
                                                 device="cpu")
    assert isinstance(count, int) and iters == 150
    assert count == _component_size(adj, [5])
    G = nx.from_scipy_sparse_array(adj)
    for g in (G, adj, (_lt_edges(adj), 300)):
        e_t, n_t = tinf._as_edges_and_n(g)
        e_j, n_j = jinf._as_edges_and_n(g)
        assert n_t == n_j == 300
        np.testing.assert_array_equal(np.asarray(e_t), np.asarray(e_j))


def _awkward_adjacency(case, seed=5):
    """``_sparse_random``'s adjacency as a CSR with explicit zeros, with
    each row's indices reversed (unsorted), with a diagonal, or all three;
    or as a COO of shuffled entries."""
    adj = _sparse_random().tocsr()
    rng = np.random.default_rng(seed)
    if case in ("diagonal", "all"):
        adj = (adj + sp.eye(adj.shape[0], format="csr")).tocsr()
    if case in ("zeros", "all"):
        adj.data[rng.choice(adj.nnz, 40, replace=False)] = 0
    if case in ("unsorted", "all"):
        for r in range(adj.shape[0]):
            lo, hi = adj.indptr[r], adj.indptr[r + 1]
            adj.indices[lo:hi] = adj.indices[lo:hi][::-1].copy()
            adj.data[lo:hi] = adj.data[lo:hi][::-1].copy()
        adj.has_sorted_indices = False
    if case == "coo":
        coo = adj.tocoo()
        order = rng.permutation(coo.nnz)
        adj = sp.coo_matrix((coo.data[order], (coo.row[order],
                                               coo.col[order])),
                            shape=adj.shape)
    return adj


@pytest.mark.fast
@pytest.mark.parametrize("case", ["plain", "zeros", "unsorted", "diagonal",
                                  "all", "coo"])
def test_sparse_extraction_equals_jax(case):
    """A CSR's upper triangle comes from the C scan (the numpy line where
    explicit zeros are stored), another format from ``nonzero()``: the
    JAX package's pairs in its order, every case."""
    jinf = pytest.importorskip("graphem_rapids_tpu.influence")
    from graphem_rapids_torch import native

    adj = _awkward_adjacency(case)
    calls = native.csr_lt_edges_native.calls
    e_t, n_t = tinf._as_edges_and_n(adj)
    e_j, n_j = jinf._as_edges_and_n(adj)
    assert n_t == n_j == adj.shape[0]
    assert e_t.shape[1] == 2 and len(e_t) > 0
    np.testing.assert_array_equal(e_t, np.asarray(e_j))
    scanned = case in ("plain", "unsorted", "diagonal")
    assert native.csr_lt_edges_native.calls == calls + scanned
    if case != "coo":
        assert e_t.dtype == np.int32


@pytest.mark.fast
def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adj = _disconnected()
    with pytest.raises(RuntimeError, match="CUDA"):
        grt.estimated_influence(adj, [1], p=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        grt.greedy_seed_selection(adj, 2)


@pytest.mark.fast
def test_greedy_chunk_gains_match_jax():
    """One gather-path greedy chunk: the port's marginal gains equal the
    same cascade's per-column counts (seed words packed directly against
    the dense (n, (C + 1) * s) mask, the base-only group last, one key,
    run r of every group on the same coins): each candidate's mean less
    the base group's. Without the base group the candidates' columns are
    the same runs, and their means (the spreads) lie within 4 standard
    errors of JAX's _marginal_chunk_table, which returns spreads, on the
    same candidates."""
    jax = pytest.importorskip("jax")
    jinf = pytest.importorskip("graphem_rapids_tpu.influence")
    jic = pytest.importorskip("graphem_rapids_tpu.ops.ic_sim")
    adj = _hub_graph()
    edges, n = _lt_edges(adj), adj.shape[0]
    cands = np.array([0, 1, 2, 3, 4, 90, 150, 0], np.int64)  # 0 twice
    s, p, iters = 512, 0.2, 50
    C = len(cands)
    base = np.zeros(n, bool)
    base[3] = True
    plan = tic.build_cascade_plan(edges, n, "cpu")
    base_t = torch.as_tensor(base)

    def chunk(base_runs):
        return tinf._marginal_chunk_table(
            plan, base_t, p, torch.Generator().manual_seed(4),
            torch.as_tensor(cands), s, iters, base_runs).numpy()

    got, spreads = chunk(s), chunk(0)
    dense = np.repeat(base[:, None], C + 1, axis=1)
    dense[cands, np.arange(C)] = True
    dense = np.repeat(dense, s, axis=1)
    counts = tic._ic_run_table(plan, pack_columns(torch.as_tensor(dense)), p,
                               torch.Generator().manual_seed(4),
                               (C + 1) * s, iters, s).numpy()
    runs = counts.reshape(C + 1, s).astype(float)
    assert got[3] == spreads[3] == -np.inf
    keep = cands != 3
    # the means are multiples of 1/512 below 2^17: exact in float32
    np.testing.assert_array_equal(
        got[keep], (runs[:C].mean(axis=1) - runs[C].mean()).astype(
            np.float32)[keep])
    np.testing.assert_array_equal(
        spreads[keep], runs[:C].mean(axis=1).astype(np.float32)[keep])
    # common coins: run r of a candidate holds at least base run r's
    # cascade, except where the candidate's own cascade came first
    assert (runs[:C][keep] >= runs[C]).mean() > 0.9
    np.testing.assert_array_equal(runs[0], runs[7])  # candidate 0 twice
    jplan = jic.build_cascade_plan(edges.astype(np.int32), n)
    want = np.asarray(jinf._marginal_chunk_table(
        jplan["table"], jplan["ov_dst"], jplan["ov_src"], base, p,
        jax.random.PRNGKey(4), cands.astype(np.int32), s, iters))
    assert want[3] == -np.inf
    se = np.sqrt(2 * runs[:C].var(axis=1, ddof=1) / s)
    assert (np.abs(spreads - want)[keep] < 4 * se[keep] + 1e-9).all(), (
        spreads, want, se)


def _two_stars():
    """Vertex 0 with leaves 1..200, vertex 201 with leaves 202..251."""
    e = [(0, j) for j in range(1, 201)] + [(201, j) for j in range(202, 252)]
    return _adj(e, 252)


def _forest(seed):
    """Random trees of distinct sizes (three of 70-160 vertices, then 30
    and 12), labels shuffled, plus isolated vertices: at p=1 the spread of
    a seed set is the size of the trees it touches."""
    rng = np.random.default_rng(seed)
    sizes = list(rng.choice(np.arange(70, 161), 3, replace=False)) + [30, 12]
    e, base = [], 0
    for size in sizes:
        e += [(base + int(rng.integers(0, i)), base + i)
              for i in range(1, size)]
        base += size
    n = base + 20
    perm = rng.permutation(n)
    return _adj([tuple(sorted((int(perm[a]), int(perm[b])))) for a, b in e],
                n)


@pytest.mark.fast
def test_two_stars_take_the_full_sweep_seeds(path):
    """Greedy's CELF caches marginal gains (F1): after vertex 0, every
    leaf of its star gains nothing, and the other star's centre wins, as
    in the full sweep (the JAX package's CELF, which caches spreads,
    picks leaf 1)."""
    adj = _two_stars()
    got, evals = grt.greedy_seed_selection(adj, 2, p=1.0, num_sims=4,
                                           device="cpu")
    assert got == [0, 201]
    if path == "scatter":
        assert evals == (252 + 251) * 4
    else:
        # the first sweep, then re-evaluations of 64 stale candidates and
        # a base group of 4 runs each, until the top is fresh
        assert evals > 252 * 4 and (evals - 252 * 4) % 4 == 0


@pytest.mark.fast
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_takes_the_largest_components(path, seed):
    """At p=1 greedy takes one vertex of each of the three largest trees,
    the lowest id of each (ties go to the lowest id), as the full sweep
    does: its largest tree holds more than one chunk of 64 candidates."""
    adj = _forest(seed)
    _, labels = connected_components(adj, directed=False)
    sizes = np.bincount(labels)
    want = [int(np.flatnonzero(labels == c).min())
            for c in np.argsort(-sizes, kind="stable")[:3]]
    assert sizes.max() > 64
    got, _ = grt.greedy_seed_selection(adj, 3, p=1.0, num_sims=4,
                                       device="cpu")
    assert got == want
    full, _ = tinf._greedy_scatter(_lt_edges(adj), adj.shape[0], 3, 1.0, 200,
                                   4, torch.Generator().manual_seed(0))
    assert full == want


@pytest.mark.fast
def test_greedy_scatter_matches_jax_greedy_scatter():
    """The port's full sweep picks JAX's full-sweep seeds on the hub graph
    (gains several standard errors apart at p=0.2, 32 runs)."""
    jax = pytest.importorskip("jax")
    jinf = pytest.importorskip("graphem_rapids_tpu.influence")
    adj = _hub_graph()
    edges, n = _lt_edges(adj), adj.shape[0]
    want, want_evals = jinf._greedy_scatter(edges.astype(np.int32), n, 3, 0.2,
                                            50, 32, jax.random.PRNGKey(0))
    got, evals = tinf._greedy_scatter(edges, n, 3, 0.2, 50, 32,
                                      torch.Generator().manual_seed(0))
    assert got == want == [0, 1, 2] and evals == want_evals


@pytest.mark.fast
def test_scatter_chunk_follows_the_state_words(monkeypatch):
    """The full sweep's chunk: JAX's 1024 candidates at most, n at most,
    and fewer where the (n, W) state of C * num_sims columns would pass
    _SCATTER_STATE_WORDS; any chunking picks the same seeds at p=1."""
    assert tinf._scatter_chunk(200, 32) == 200
    assert tinf._scatter_chunk(5000, 32) == tinf.GREEDY_CAND_CHUNK
    # 2^27 words // 12M vertices = 11 words: 352 columns
    assert tinf._scatter_chunk(12_000_000, 32) == 11
    assert tinf._scatter_chunk(12_000_000, 64) == 5
    assert tinf._scatter_chunk(10**9, 64) == 1
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    monkeypatch.setattr(tinf, "_SCATTER_STATE_WORDS", 252)
    assert tinf._scatter_chunk(252, 4) == 8
    got, evals = grt.greedy_seed_selection(_two_stars(), 2, p=1.0,
                                           num_sims=4, device="cpu")
    assert got == [0, 201] and evals == (252 + 251) * 4
