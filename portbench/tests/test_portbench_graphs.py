"""The graph generators at a shrunk size."""

import numpy as np
import pytest

from conftest import family, make_graph


def spec(family, n=20_000, chords=60_000):
    s = {"family": family, "vertices": n, "chords": chords}
    if family == "skewed":
        s["zipf_a"] = 1.6
    return s


@pytest.mark.parametrize("family", ["ring", "skewed"])
def test_symmetric_simple_and_sized(family):
    adj, stats = make_graph(spec(family), 7, "cpu")
    n = adj.shape[0]
    assert (adj != adj.T).nnz == 0
    assert adj.diagonal().sum() == 0
    assert set(np.unique(adj.data)) == {1.0}
    assert adj.has_sorted_indices
    E = adj.nnz // 2
    assert stats["E"] == E
    # the ring and at most every chord, less self loops and duplicates
    assert n <= E <= n + 60_000
    ring = adj[np.arange(n), (np.arange(n) + 1) % n]
    assert np.all(np.asarray(ring) == 1)
    assert stats["max_degree"] == int(np.diff(adj.indptr).max())


@pytest.mark.parametrize("family", ["ring", "skewed"])
def test_same_seed_same_graph(family):
    a, _ = make_graph(spec(family), 99, "cpu")
    b, _ = make_graph(spec(family), 99, "cpu")
    c, _ = make_graph(spec(family), 100, "cpu")
    assert (a != b).nnz == 0
    assert (a != c).nnz > 0


def test_large_seed():
    adj, _ = make_graph(spec("ring", 1000, 2000), 2**31 + 12345,
                               "cpu")
    assert adj.shape == (1000, 1000)


def test_zipf_hubs():
    """Vertex 0 takes P(Z = 1) = 1/zeta(1.6) of the chords' first ends,
    less its duplicates, and the degrees fall with the rank."""
    n, chords = 20_000, 60_000
    adj, stats = make_graph(spec("skewed", n, chords), 3, "cpu")
    deg = np.diff(adj.indptr)
    share = 1 / 2.2857  # 1 / zeta(1.6)
    want = n * (1 - np.exp(-share * chords / n))  # distinct partners
    assert abs(deg[0] - want) < 0.05 * want
    assert deg[0] == stats["max_degree"]
    assert deg[0] > deg[1] > deg[10] > np.median(deg)


def test_zipf_ranks_follow_the_law():
    import torch

    gen = torch.Generator().manual_seed(5)
    skewed = family("skewed")
    zipf_ranks = skewed.__globals__["zipf_ranks"]
    r = zipf_ranks(200_000, 1.6, 1000, gen, "cpu").numpy()
    assert r.min() >= 0 and r.max() <= 999
    k = np.arange(1, 4)
    want = k ** -1.6 / 2.2857
    got = np.array([(r == i - 1).mean() for i in k])
    assert np.allclose(got, want, atol=0.005)
