"""Host-side graph preparation of the PyTorch port against the JAX package.

The port's numpy builders (graphem_rapids_torch/ops/forces.py) must give
arrays EQUAL to the JAX builders' (``to_device=False``) on the same edges:
the tables, slot maps, overflow pairs and overflow plans are the state both
engines derive from a graph, so any difference changes the trajectory.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import graphem_rapids_tpu as gr
from graphem_rapids_tpu.ops import forces as jf
from graphem_rapids_torch.models.embedder import GraphEmbedderTorch
from graphem_rapids_torch.ops import forces as tf


def _edges(adj):
    rows, cols = sp.triu(sp.csr_matrix(adj), k=1).nonzero()
    e = np.column_stack([rows, cols]).astype(np.int64)
    return e[np.lexsort((e[:, 1], e[:, 0]))]


def _skewed_edges(n=400, seed=2):
    """The hub graph of tests/test_binned_table.py."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 300)] + [(1, j) for j in range(2, 200)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (700, 2)) if a != b]
    return np.unique(np.array(sorted(set(e)), np.int64), axis=0), n


def _hub_edges():
    """The overflow graph of tests/test_table_cap.py."""
    rng = np.random.default_rng(2)
    e = [(0, j) for j in range(1, 400)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, 500, (800, 2)) if a != b]
    return np.unique(np.array(sorted(set(e)), np.int64), axis=0), 500


def _ring_chords_edges(n=2000, chords=6000, seed=0):
    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    ch = rng.integers(0, n, (chords, 2))
    e = np.concatenate([ring, ch[ch[:, 0] != ch[:, 1]]])
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
    return e, n


def _graphs():
    er = gr.erdos_renyi_graph(300, 0.03, seed=0)
    ba = gr.generate_ba(n=500, m=3, seed=0)
    reg = gr.generate_random_regular(n=200, d=6, seed=0)
    return {
        "skewed": _skewed_edges(),
        "hub": _hub_edges(),
        "er300": (_edges(er), 300),
        "ba500": (_edges(ba), 500),
        "regular": (_edges(reg), 200),
        "ring_chords_2000": _ring_chords_edges(),
    }


GRAPHS = _graphs()


def _assert_same(port, ref, path="nb"):
    """Every key of the port's dict equals the JAX dict's value."""
    if ref is None or port is None:
        assert port is None and ref is None, path
        return
    if isinstance(port, dict):
        for key, val in port.items():
            _assert_same(val, ref[key], f"{path}[{key!r}]")
        return
    if isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
        return
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("cap", [None, 3])
def test_flat_table_equals_jax(name, cap):
    edges, n = GRAPHS[name]
    port = tf.build_neighbor_table(edges, n, cap=cap)
    ref = jf.build_neighbor_table(edges, n, cap=cap, to_device=False)
    _assert_same(port, ref)
    assert set(port) == set(ref)


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("overhead_rows", [0, 4096])
def test_binned_table_equals_jax(name, overhead_rows):
    edges, n = GRAPHS[name]
    port = tf.build_neighbor_table_binned(edges, n, overhead_rows=overhead_rows)
    ref = jf.build_neighbor_table_binned(edges, n, overhead_rows=overhead_rows,
                                         to_device=False)
    _assert_same(port, ref)
    if overhead_rows == 0 and name != "regular":
        assert port is not None and len(port["buckets"]) > 1


@pytest.mark.fast
def test_binned_none_for_regular_graph():
    edges, n = GRAPHS["regular"]
    assert tf.build_neighbor_table_binned(edges, n, overhead_rows=0) is None
    assert jf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                          to_device=False) is None


@pytest.mark.fast
@pytest.mark.parametrize("name", ["skewed", "ring_chords_2000"])
def test_ref_budget_trim_equals_jax(name):
    """A ref budget that binds trims the same columns in both packages."""
    edges, n = GRAPHS[name]
    full = tf.build_neighbor_table(edges, n)
    budget = int(len(full["ref_edge"]) * 0.8)
    _assert_same(tf.build_neighbor_table(edges, n, ref_budget=budget),
                 jf.build_neighbor_table(edges, n, ref_budget=budget,
                                         to_device=False))
    full_b = tf.build_neighbor_table_binned(edges, n, overhead_rows=0)
    budget_b = int(len(full_b["ref_edge"]) * 0.9)
    port = tf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                          ref_budget=budget_b)
    assert len(port["ref_edge"]) < len(full_b["ref_edge"])
    _assert_same(port, jf.build_neighbor_table_binned(
        edges, n, overhead_rows=0, ref_budget=budget_b, to_device=False))


@pytest.mark.fast
def test_optimal_table_cap_equals_jax():
    rng = np.random.default_rng(0)
    star = np.ones(10_000, np.int64)
    star[0] = 9_999
    for deg in (
        np.full(1000, 8),
        star,
        rng.poisson(8, 5000),
        np.minimum(rng.zipf(1.7, 5000), 4000),
        rng.integers(1, 40, 5000),
        np.full(10, 5000),
    ):
        assert tf._optimal_table_cap(deg, len(deg)) == \
            jf._optimal_table_cap(deg, len(deg))
    assert tf._optimal_table_cap(np.full(10, 5000), 10, max_cap=64) == \
        jf._optimal_table_cap(np.full(10, 5000), 10, max_cap=64)


@pytest.mark.fast
def test_plan_degree_buckets_equals_jax():
    rng = np.random.default_rng(1)
    for deg, kw in (
        (rng.poisson(8, 5000), {}),
        (np.minimum(rng.zipf(1.7, 5000), 60), {"overhead_rows": 0}),
        (rng.integers(1, 40, 5000), {"overhead_rows": 0, "max_buckets": 3}),
        (np.full(100, 4), {}),
    ):
        assert tf.plan_degree_buckets(deg, **kw) == \
            jf.plan_degree_buckets(deg, **kw)


@pytest.mark.fast
def test_overflow_plan_equals_jax():
    rng = np.random.default_rng(1)
    hubs = np.repeat([3, 7, 42], [500, 300, 130])
    overflow = np.stack([hubs, rng.integers(0, 1000, hubs.shape)],
                        axis=1).astype(np.int32)
    port = tf.build_overflow_plan(overflow)
    assert port is not None
    _assert_same(port, jf.build_overflow_plan(overflow))
    singles = np.stack([np.arange(5000), np.arange(5000) + 1],
                       axis=1).astype(np.int32)
    assert tf.build_overflow_plan(singles) is None
    assert tf.build_overflow_plan(np.zeros((0, 2), np.int32)) is None


@pytest.mark.fast
def test_empty_and_guarded_inputs():
    empty = np.zeros((0, 2), np.int64)
    _assert_same(tf.build_neighbor_table(empty, 5),
                 jf.build_neighbor_table(empty, 5, to_device=False))
    assert tf.build_neighbor_table_binned(empty, 5) is None

    class FakeEdges:
        def __len__(self):
            return 1 << 30

    with pytest.raises(ValueError, match="int32"):
        tf.build_neighbor_table_binned(FakeEdges(), 1000)


@pytest.mark.fast
@pytest.mark.parametrize("make_adj", [
    lambda: gr.erdos_renyi_graph(200, 0.05, seed=4),
    lambda: gr.generate_ba(n=300, m=2, seed=1),
])
def test_edge_extraction_equals_jax(make_adj):
    adj = make_adj()
    adj = sp.csr_matrix(adj)
    adj.data[:5] = 0  # explicit zeros are not edges
    port = GraphEmbedderTorch(adj, device="cpu", verbose=False, seed=0,
                              init="random")
    ref = gr.GraphEmbedderTPU(adj, verbose=False, seed=0, init="random")
    np.testing.assert_array_equal(port._edges_np, ref._edges_np)
    assert port._edges_np.dtype == np.int32
