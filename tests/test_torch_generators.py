"""The port's generators against the JAX package's (tests/test_generators.py).

The deterministic generators must give JAX's adjacency exactly. The random
ones cannot follow networkx's random streams, so they are held to JAX's
format contract (sparse CSR, square, symmetric, loop-free, binary), to
reproducibility per seed, and to their model's definition: edge counts of
G(n, p), SBM and bipartite graphs within 5 standard deviations of their
means, m edges per new BA vertex, the WS lattice and its edge count, every
random-regular degree equal to d, an edge of the geometric graph exactly
when the distance is at most the radius, and so on.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import graphem_rapids_tpu as gr
import graphem_rapids_torch as grt
from graphem_rapids_torch.generators import _edges_to_sparse_adjacency

ALL_GENERATORS = [
    (grt.erdos_renyi_graph, {"n": 60, "p": 0.1, "seed": 0}),
    (grt.generate_sbm, {"n_per_block": 15, "num_blocks": 3, "seed": 0}),
    (grt.generate_ba, {"n": 60, "m": 2, "seed": 0}),
    (grt.generate_ws, {"n": 60, "k": 4, "p": 0.2, "seed": 0}),
    (grt.generate_power_cluster, {"n": 60, "m": 2, "p": 0.3, "seed": 0}),
    (grt.generate_road_network, {"width": 6, "height": 6}),
    (grt.generate_bipartite_graph, {"n_top": 12, "n_bottom": 20, "seed": 0}),
    (grt.generate_balanced_tree, {"r": 2, "h": 4}),
    (grt.generate_random_regular, {"n": 60, "d": 3, "seed": 0}),
    (grt.generate_scale_free, {"n": 60, "seed": 0}),
    (grt.generate_geometric, {"n": 60, "radius": 0.3, "seed": 0}),
    (grt.generate_caveman, {"l": 5, "k": 6}),
    (grt.generate_relaxed_caveman, {"l": 5, "k": 6, "p": 0.1, "seed": 0}),
]
RANDOM = [(g, p) for g, p in ALL_GENERATORS if "seed" in p]

DETERMINISTIC = {
    "road_6x6": ("generate_road_network", {"width": 6, "height": 6}),
    "road_4x5": ("generate_road_network", {"width": 4, "height": 5}),
    "road_1x7": ("generate_road_network", {"width": 1, "height": 7}),
    "tree_2_4": ("generate_balanced_tree", {"r": 2, "h": 4}),
    "tree_3_3": ("generate_balanced_tree", {"r": 3, "h": 3}),
    "tree_1_5": ("generate_balanced_tree", {"r": 1, "h": 5}),
    "caveman_5_6": ("generate_caveman", {"l": 5, "k": 6}),
    "caveman_3_1": ("generate_caveman", {"l": 3, "k": 1}),
}


def _edges(adj):
    rows, cols = adj.nonzero()
    keep = rows < cols
    return np.column_stack([rows[keep], cols[keep]])


@pytest.mark.fast
@pytest.mark.parametrize("gen,params", ALL_GENERATORS,
                         ids=[g.__name__ for g, _ in ALL_GENERATORS])
def test_format_contract(gen, params):
    adj = gen(**params)
    assert isinstance(adj, sp.csr_matrix)
    assert adj.shape[0] == adj.shape[1]
    assert (adj != adj.T).nnz == 0
    assert adj.diagonal().sum() == 0
    assert set(np.unique(adj.data)).issubset({1})
    assert adj.dtype.kind == "i"


@pytest.mark.fast
@pytest.mark.parametrize("case", list(DETERMINISTIC))
def test_deterministic_generators_equal_jax(case):
    name, params = DETERMINISTIC[case]
    got, want = getattr(grt, name)(**params), getattr(gr, name)(**params)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.fast
@pytest.mark.parametrize("gen,params", RANDOM,
                         ids=[g.__name__ for g, _ in RANDOM])
def test_seed_reproducibility(gen, params):
    a, b = gen(**params), gen(**params)
    assert a.shape == b.shape and (a != b).nnz == 0
    other = gen(**dict(params, seed=params["seed"] + 1))
    assert other.shape != a.shape or (a != other).nnz != 0


@pytest.mark.fast
def test_er_seed_reproducibility():
    a = grt.erdos_renyi_graph(50, 0.1, seed=7)
    b = grt.erdos_renyi_graph(50, 0.1, seed=7)
    assert (a != b).nnz == 0
    c = grt.erdos_renyi_graph(50, 0.1, seed=8)
    assert (a != c).nnz != 0


def _within_5_sd(count, trials, p):
    mean, sd = trials * p, np.sqrt(trials * p * (1 - p))
    return abs(count - mean) < 5 * sd


@pytest.mark.fast
def test_er_edge_count():
    n, p = 400, 0.05
    adj = grt.erdos_renyi_graph(n, p, seed=3)
    assert _within_5_sd(adj.nnz // 2, n * (n - 1) // 2, p)
    assert grt.erdos_renyi_graph(30, 0.0, seed=0).nnz == 0
    assert grt.erdos_renyi_graph(30, 1.0, seed=0).nnz == 30 * 29


@pytest.mark.fast
def test_sbm_block_densities():
    b, k, p_in, p_out = 60, 3, 0.2, 0.02
    adj, labels = grt.generate_sbm(n_per_block=b, num_blocks=k, p_in=p_in,
                                   p_out=p_out, labels=True, seed=1)
    e = _edges(adj)
    same = labels[e[:, 0]] == labels[e[:, 1]]
    assert _within_5_sd(int(same.sum()), k * b * (b - 1) // 2, p_in)
    assert _within_5_sd(int((~same).sum()), k * (k - 1) // 2 * b * b, p_out)


@pytest.mark.fast
def test_sbm_labels():
    adj, labels = grt.generate_sbm(n_per_block=10, num_blocks=3, labels=True,
                                   seed=0)
    assert adj.shape == (30, 30)
    assert labels.shape == (30,)
    assert set(labels) == {0, 1, 2}


@pytest.mark.fast
@pytest.mark.parametrize("n,m", [(60, 2), (500, 3), (10, 1)])
def test_ba_m_edges_per_new_vertex(n, m):
    adj = grt.generate_ba(n=n, m=m, seed=0)
    assert adj.nnz // 2 == m * (n - m)
    e = _edges(adj)
    earlier = np.bincount(e[:, 1], minlength=n)  # neighbours below each
    np.testing.assert_array_equal(earlier[m + 1:], m)
    np.testing.assert_array_equal(earlier[1:m + 1], 1)  # the star
    if n >= 500:  # preferential attachment's hubs
        deg = grt.compute_vertex_degrees(adj)
        assert deg.max() > 3 * deg.mean()


@pytest.mark.fast
def test_ws_lattice_and_rewiring():
    n, k = 80, 6
    lattice = grt.generate_ws(n=n, k=k, p=0.0, seed=0)
    ring = [(u, (u + j) % n) for u in range(n) for j in range(1, k // 2 + 1)]
    want = _edges_to_sparse_adjacency(np.array(ring), n)
    np.testing.assert_array_equal(lattice.toarray(), want.toarray())
    for p in (0.3, 1.0):
        adj = grt.generate_ws(n=n, k=k, p=p, seed=0)
        assert adj.nnz // 2 == n * k // 2  # rewiring keeps the count
        assert (adj != lattice).nnz > 0


@pytest.mark.fast
def test_power_cluster_growth_and_triangles():
    n, m = 400, 3
    adj0 = grt.generate_power_cluster(n=n, m=m, p=0.0, seed=0)
    adj9 = grt.generate_power_cluster(n=n, m=m, p=0.9, seed=0)
    for adj in (adj0, adj9):
        e = _edges(adj)
        earlier = np.bincount(e[:, 1], minlength=n)[m:]
        assert earlier.min() >= 1 and earlier.max() <= m
        assert adj.nnz // 2 <= m * (n - m)
    assert adj0.nnz // 2 == m * (n - m)  # no triangle step, m targets

    def triangles(adj):
        a = adj.astype(np.int64)
        return int((a @ a).multiply(a).sum()) // 6

    assert triangles(adj9) > 2 * triangles(adj0)


@pytest.mark.fast
def test_bipartite_has_no_intra_side_edges():
    top, bottom, p = 30, 50, 0.2
    adj = grt.generate_bipartite_graph(n_top=top, n_bottom=bottom, p=p,
                                       seed=2)
    assert adj.shape == (top + bottom,) * 2
    e = _edges(adj)
    assert (e[:, 0] < top).all() and (e[:, 1] >= top).all()
    assert _within_5_sd(len(e), top * bottom, p)


@pytest.mark.fast
@pytest.mark.parametrize("n,d", [(50, 4), (60, 3), (2000, 8)])
def test_random_regular_degrees(n, d):
    adj = grt.generate_random_regular(n=n, d=d, seed=0)
    assert adj.shape == (n, n)
    assert (grt.compute_vertex_degrees(adj) == d).all()
    with pytest.raises(ValueError):
        grt.generate_random_regular(n=5, d=3, seed=0)  # n * d odd


@pytest.mark.fast
def test_scale_free_is_symmetrized_and_heavy_tailed():
    adj = grt.generate_scale_free(n=2000, seed=0)
    assert adj.shape == (2000, 2000)
    assert (adj != adj.T).nnz == 0 and adj.diagonal().sum() == 0
    deg = grt.compute_vertex_degrees(adj)
    assert deg.max() > 10 * deg.mean()


@pytest.mark.fast
@pytest.mark.parametrize("dim,radius", [(2, 0.15), (3, 0.3)])
def test_geometric_edge_iff_within_radius(dim, radius):
    n, seed = 300, 4
    adj = grt.generate_geometric(n=n, radius=radius, dim=dim, seed=seed)
    pos = np.random.default_rng(seed).random((n, dim))
    dist = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    want = (dist <= radius) & ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(adj.toarray().astype(bool), want)


@pytest.mark.fast
def test_relaxed_caveman_rewires_caveman():
    l, k = 6, 5
    cave = grt.generate_caveman(l=l, k=k)
    np.testing.assert_array_equal(
        grt.generate_relaxed_caveman(l=l, k=k, p=0.0, seed=0).toarray(),
        cave.toarray())
    adj = grt.generate_relaxed_caveman(l=l, k=k, p=0.3, seed=0)
    assert adj.nnz == cave.nnz  # a rewired edge keeps the count
    assert (adj != cave).nnz > 0 and adj.diagonal().sum() == 0


@pytest.mark.fast
def test_balanced_tree_size():
    adj = grt.generate_balanced_tree(r=2, h=3)
    assert adj.shape[0] == 2**4 - 1
    assert adj.nnz // 2 == 14


@pytest.mark.fast
def test_road_network_size():
    adj = grt.generate_road_network(width=4, height=5)
    assert adj.shape[0] == 20
    assert adj.nnz // 2 == 4 * 4 + 5 * 3


@pytest.mark.fast
def test_compute_vertex_degrees():
    dense = np.array([[0, 1, 1], [1, 0, 0], [1, 0, 0]])
    degrees = grt.compute_vertex_degrees(sp.csr_matrix(dense))
    assert degrees.tolist() == [2, 1, 1]
    adj = gr.generate_ba(n=100, m=2, seed=1)
    np.testing.assert_array_equal(grt.compute_vertex_degrees(adj),
                                  gr.compute_vertex_degrees(adj))


@pytest.mark.fast
def test_edges_to_sparse_adjacency_helper():
    from graphem_rapids_tpu.generators import (
        _edges_to_sparse_adjacency as jax_helper,
    )

    edges = np.array([[0, 1], [1, 2], [2, 1]])
    adj = _edges_to_sparse_adjacency(edges, 4)
    assert adj.shape == (4, 4)
    assert adj.nnz == 4
    np.testing.assert_array_equal(adj.toarray(),
                                  jax_helper(edges, 4).toarray())
    empty = _edges_to_sparse_adjacency(np.empty((0, 2)), 3)
    assert empty.nnz == 0 and empty.shape == (3, 3)
