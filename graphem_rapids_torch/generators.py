"""Graph generators, in numpy and scipy.

Counterpart of ``graphem_rapids_tpu/generators.py``: the same 13 generators,
each returning a symmetric, loop-free scipy CSR adjacency with int entries
1. The JAX package wraps networkx, which the card's machine lacks, so these
are rebuilt here:

- the deterministic ones (``generate_road_network``,
  ``generate_balanced_tree``, ``generate_caveman``) give the JAX adjacency
  exactly, node order included;
- the random ones cannot follow networkx's random streams. Each is
  reproducible per seed (``np.random.default_rng``) and follows the
  model's definition; G(n, p), the stochastic block model, the bipartite
  graph and the random geometric graph are vectorized, the growth models
  (BA, powerlaw cluster, scale-free) and the rewiring ones (WS, relaxed
  caveman, the d-regular pairing) are sequential by nature and loop in
  Python. One deliberate difference: the relaxed caveman never rewires an
  edge onto a self-loop.
"""

from itertools import combinations

import numpy as np
import scipy.sparse as sp


def _edges_to_sparse_adjacency(edges, n):
    """Edge list -> symmetric sparse CSR adjacency."""
    edges = np.asarray(edges)
    if len(edges) == 0:
        return sp.csr_matrix((n, n), dtype=int)
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    data = np.ones(len(rows), dtype=int)
    adj = sp.csr_matrix((data, (rows, cols)), shape=(n, n))
    adj.data[:] = 1  # collapse duplicates
    return adj


def _sets_to_adjacency(nbrs):
    """Adjacency sets (one per vertex) -> sparse CSR adjacency."""
    edges = [(u, v) for u, vs in enumerate(nbrs) for v in vs if u < v]
    return _edges_to_sparse_adjacency(np.array(edges, np.int64).reshape(-1, 2),
                                      len(nbrs))


def compute_vertex_degrees(adjacency):
    """Per-vertex degree from the adjacency (row sums)."""
    return np.array(adjacency.sum(axis=1)).flatten()


def _bernoulli_pairs(rng, n_pairs, p):
    """Indices of the pairs kept when each of ``n_pairs`` is kept with
    probability p: a Binomial(n_pairs, p) count, then that many distinct
    indices uniformly (the same law as n_pairs coin flips)."""
    m = rng.binomial(n_pairs, p)
    return np.sort(rng.choice(n_pairs, size=m, replace=False))


def _unordered_pairs(idx):
    """Pair index -> (i, j), i < j, in the order (0,1), (0,2), (1,2), ...
    (index j * (j - 1) / 2 + i)."""
    idx = np.asarray(idx, np.int64)
    j = np.floor((1 + np.sqrt(1 + 8 * idx.astype(np.float64))) / 2).astype(
        np.int64)
    j -= (j * (j - 1) // 2) > idx  # float rounding, either way
    j += ((j + 1) * j // 2) <= idx
    i = idx - j * (j - 1) // 2
    return np.column_stack([i, j])


def _gnp_edges(rng, n, p, offset=0):
    """G(n, p) edges among vertices offset .. offset + n - 1."""
    return _unordered_pairs(_bernoulli_pairs(rng, n * (n - 1) // 2, p)) + offset


def _bipartite_edges(rng, n_a, n_b, p, off_a, off_b):
    """Each of the n_a * n_b cross pairs kept with probability p."""
    idx = _bernoulli_pairs(rng, n_a * n_b, p)
    return np.column_stack([idx // n_b + off_a, idx % n_b + off_b])


def erdos_renyi_graph(n, p, seed=0):
    """Erdős–Rényi G(n, p) random graph -> sparse CSR adjacency."""
    rng = np.random.default_rng(seed)
    return _edges_to_sparse_adjacency(_gnp_edges(rng, n, p), n)


def generate_sbm(n_per_block=75, num_blocks=4, p_in=0.15, p_out=0.01,
                 labels=False, seed=0):
    """Stochastic block model; optionally returns block labels."""
    rng = np.random.default_rng(seed)
    parts = []
    for a in range(num_blocks):
        for b in range(a, num_blocks):
            if a == b:
                parts.append(_gnp_edges(rng, n_per_block, p_in,
                                        a * n_per_block))
            else:
                parts.append(_bipartite_edges(rng, n_per_block, n_per_block,
                                              p_out, a * n_per_block,
                                              b * n_per_block))
    n = n_per_block * num_blocks
    adjacency = _edges_to_sparse_adjacency(
        np.concatenate(parts) if parts else np.zeros((0, 2), np.int64), n)
    if labels:
        vertex_labels = np.repeat(np.arange(num_blocks), n_per_block)
        return adjacency, vertex_labels
    return adjacency


def _distinct_picks(rng, pool, size, m):
    """m distinct values drawn uniformly from the first ``size`` entries of
    ``pool`` (a list with repeats: preferential attachment)."""
    picked = set()
    while len(picked) < m:
        picked.add(int(pool[rng.integers(size)]))
    return picked


def generate_ba(n=300, m=3, seed=0):
    """Barabási–Albert preferential-attachment graph: a star on m + 1
    vertices, then each new vertex attaches to m distinct vertices drawn
    with probability proportional to degree."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert needs 1 <= m < n, got m={m}, n={n}")
    rng = np.random.default_rng(seed)
    edges = np.empty((m * (n - m), 2), np.int64)
    edges[:m] = np.column_stack([np.zeros(m, np.int64), np.arange(1, m + 1)])
    # every endpoint once per incident edge: drawing from it is drawing
    # proportional to degree
    pool = np.empty(2 * len(edges), np.int64)
    pool[:2 * m] = edges[:m].ravel()
    size, e = 2 * m, m
    for v in range(m + 1, n):
        for u in _distinct_picks(rng, pool, size, m):
            edges[e] = (v, u)
            pool[size:size + 2] = (v, u)
            size += 2
            e += 1
    return _edges_to_sparse_adjacency(edges, n)


def generate_ws(n=1000, k=6, p=0.3, seed=0):
    """Watts–Strogatz small-world graph: a ring lattice, each vertex tied
    to its k // 2 nearest neighbours on each side, then each lattice edge
    (u, u + j) rewired with probability p to (u, w), w uniform among the
    vertices that are neither u nor already u's neighbours."""
    rng = np.random.default_rng(seed)
    nbrs = [set() for _ in range(n)]
    for j in range(1, k // 2 + 1):
        for u in range(n):
            v = (u + j) % n
            if u != v:
                nbrs[u].add(v)
                nbrs[v].add(u)
    for j in range(1, k // 2 + 1):
        rewire = rng.random(n) < p
        for u in np.flatnonzero(rewire):
            u = int(u)
            v = (u + j) % n
            if v not in nbrs[u] or len(nbrs[u]) >= n - 1:
                continue
            w = int(rng.integers(n))
            while w == u or w in nbrs[u]:
                w = int(rng.integers(n))
            nbrs[u].discard(v)
            nbrs[v].discard(u)
            nbrs[u].add(w)
            nbrs[w].add(u)
    return _sets_to_adjacency(nbrs)


def generate_power_cluster(n=1000, m=3, p=0.5, seed=0):
    """Powerlaw cluster graph (Holme–Kim): preferential attachment of m
    edges per new vertex, each edge after the first closing a triangle
    with probability p (to a neighbour of the last target)."""
    if m < 1 or m > n:
        raise ValueError(f"powerlaw cluster needs 1 <= m <= n, got m={m}")
    rng = np.random.default_rng(seed)
    nbrs = [set() for _ in range(n)]
    pool = list(range(m))
    for source in range(m, n):
        targets = list(_distinct_picks(rng, pool, len(pool), m))
        rng.shuffle(targets)
        target = targets.pop()
        nbrs[source].add(target)
        nbrs[target].add(source)
        pool.append(target)
        count = 1
        while count < m:
            if rng.random() < p:
                closing = sorted(w for w in nbrs[target]
                                 if w != source and w not in nbrs[source])
                if closing:
                    w = closing[rng.integers(len(closing))]
                    nbrs[source].add(w)
                    nbrs[w].add(source)
                    pool.append(w)
                    count += 1
                    continue
            target = targets.pop()
            nbrs[source].add(target)
            nbrs[target].add(source)
            pool.append(target)
            count += 1
        pool.extend([source] * m)
    return _sets_to_adjacency(nbrs)


def generate_road_network(width=30, height=30):
    """2D grid graph (road-network proxy): vertex (i, j) is i * height + j,
    the row-major order of networkx's grid_2d_graph relabelled to ints."""
    ids = np.arange(width * height).reshape(width, height)
    edges = np.concatenate([
        np.column_stack([ids[:-1].ravel(), ids[1:].ravel()]),
        np.column_stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()]),
    ])
    return _edges_to_sparse_adjacency(edges, width * height)


def generate_bipartite_graph(n_top=50, n_bottom=100, p=0.1, seed=None):
    """Random bipartite graph over n_top + n_bottom vertices: each
    top-bottom pair an edge with probability p, no edge within a side."""
    rng = np.random.default_rng(seed)
    return _edges_to_sparse_adjacency(
        _bipartite_edges(rng, n_top, n_bottom, p, 0, n_top), n_top + n_bottom)


def generate_balanced_tree(r=2, h=10):
    """Balanced r-ary tree of height h: vertex j > 0 hangs from (j - 1) // r,
    networkx's numbering."""
    n = h + 1 if r == 1 else (r ** (h + 1) - 1) // (r - 1)
    child = np.arange(1, n)
    return _edges_to_sparse_adjacency(
        np.column_stack([(child - 1) // r, child]).reshape(-1, 2), n)


def generate_random_regular(n=100, d=3, seed=0):
    """Random d-regular graph: the pairing model, with unusable pairs
    (loops, repeats) re-paired among their stubs and a fresh start when
    none can be (the Steger–Wormald scheme networkx uses)."""
    if (n * d) % 2 or not 0 <= d < n:
        raise ValueError(f"no {d}-regular graph on {n} vertices")
    rng = np.random.default_rng(seed)
    while True:
        edges = _try_regular(rng, n, d)
        if edges is not None:
            return _edges_to_sparse_adjacency(
                np.array(sorted(edges), np.int64).reshape(-1, 2), n)


def _try_regular(rng, n, d):
    """One pairing attempt; the edge set, or None when it got stuck."""
    edges = set()
    stubs = np.repeat(np.arange(n), d)
    while len(stubs):
        stubs = rng.permutation(stubs)
        left = []
        for a, b in zip(stubs[0::2].tolist(), stubs[1::2].tolist()):
            a, b = min(a, b), max(a, b)
            if a != b and (a, b) not in edges:
                edges.add((a, b))
            else:
                left += [a, b]
        if left and not _can_pair(edges, set(left)):
            return None
        stubs = np.array(left, np.int64)
    return edges


def _can_pair(edges, vertices):
    """True if two of the vertices with stubs left may still be joined."""
    return any(a != b and (min(a, b), max(a, b)) not in edges
               for a, b in combinations(vertices, 2))


def generate_scale_free(n=100, alpha=0.41, beta=0.54, gamma=0.05,
                        delta_in=0.2, delta_out=0, seed=0):
    """Directed scale-free graph (Bollobás et al.), symmetrized with
    self-loops removed. From the cycle 0 -> 1 -> 2 -> 0, each step adds,
    with probability alpha, an edge from a new vertex to w; with beta, an
    edge v -> w between old vertices; with gamma, an edge from v to a new
    vertex; v is drawn with probability proportional to out-degree +
    delta_out and w to in-degree + delta_in."""
    if not np.isclose(alpha + beta + gamma, 1.0):
        raise ValueError("alpha + beta + gamma must equal 1")
    rng = np.random.default_rng(seed)
    src, dst = [0, 1, 2], [1, 2, 0]
    n_nodes = 3

    def pick(ends, delta):
        # ends lists each vertex once per edge end: a draw from it is
        # proportional to degree; delta adds a uniform share
        if delta > 0:
            bias = n_nodes * delta
            if rng.random() < bias / (bias + len(ends)):
                return int(rng.integers(n_nodes))
        return ends[rng.integers(len(ends))]

    while n_nodes < n:
        r = rng.random()
        if r < alpha:
            v, w = n_nodes, pick(dst, delta_in)
            n_nodes += 1
        elif r < alpha + beta:
            v, w = pick(src, delta_out), pick(dst, delta_in)
        else:
            v, w = pick(src, delta_out), n_nodes
            n_nodes += 1
        src.append(v)
        dst.append(w)
    e = np.column_stack([src, dst]).astype(np.int64)
    return _edges_to_sparse_adjacency(e[e[:, 0] != e[:, 1]], n_nodes)


def generate_geometric(n=100, radius=0.2, dim=2, seed=0):
    """Random geometric graph: n points uniform in the unit cube
    (``default_rng(seed).random((n, dim))``), an edge exactly when two
    points are at most ``radius`` apart."""
    from scipy.spatial import cKDTree

    pos = np.random.default_rng(seed).random((n, dim))
    pairs = cKDTree(pos).query_pairs(radius, output_type="ndarray")
    return _edges_to_sparse_adjacency(pairs, n)


def _caveman_edges(l, k):
    """l disjoint k-cliques on consecutive vertex blocks."""
    if k < 2:
        return np.zeros((0, 2), np.int64)
    i, j = np.triu_indices(k, 1)
    base = np.arange(l)[:, None] * k
    return np.column_stack([(base + i).ravel(), (base + j).ravel()])


def generate_caveman(l=10, k=10):
    """Caveman graph: l disjoint cliques of size k."""
    return _edges_to_sparse_adjacency(_caveman_edges(l, k), l * k)


def generate_relaxed_caveman(l=10, k=10, p=0.1, seed=0):
    """Relaxed caveman graph: the caveman graph with each edge (u, v)
    rewired with probability p to (u, x), x uniform, kept when (u, x) is
    neither an edge nor a loop."""
    rng = np.random.default_rng(seed)
    n = l * k
    nbrs = [set() for _ in range(n)]
    edges = _caveman_edges(l, k).tolist()
    for u, v in edges:
        nbrs[u].add(v)
        nbrs[v].add(u)
    for u, v in edges:
        if rng.random() < p:
            x = int(rng.integers(n))
            if x == u or x in nbrs[u]:
                continue
            nbrs[u].discard(v)
            nbrs[v].discard(u)
            nbrs[u].add(x)
            nbrs[x].add(u)
    return _sets_to_adjacency(nbrs)
