"""The layout iteration and its start, in plain torch, from the graph.

One iteration of GraphEm's force-directed layout, as its semantics state
it (``graphem_rapids_torch/models/embedder.py`` describes the same six
stages), on positions in the user's vertex order:

1. the sampled edges: S distinct internal edge ids, drawn by the
   engine's sample rule from a generator seeded with the engine's seed,
   one draw an iteration (``SampleDraws`` draws them again and holds the
   program's to them);
2. spring forces along every edge, -k_attr (|u - v| + eps - L_min)
   (u - v) / (|u - v| + eps) on v from each neighbour u;
3. edge midpoints (u + v) / 2, taken in float32 as the program takes them,
   laid out in the ref array of ``tables.ref_space``;
4. the k+1 neighbours of each sampled midpoint by the bin-fold rule
   (``binfold.knn_binfold``), the first (the midpoint itself) dropped;
5. repulsion k_inter (x - m) / (|x - m| + eps)^2 on the four endpoints of
   each sampled pair (i, j) with user edge id i < j, no shared vertex and
   a proper crossing in the first two coordinates, m the mean of the four;
6. the sum, centred, divided by the unbiased std + eps per coordinate.

Every term (the springs, the midpoints and distances, the crossing test,
the repulsions) is taken in ``dtype``, by the arithmetic the program's
plain versions state: float32, the precision the configuration states,
for the reference, and bfloat16 for the control. Every sum is taken in
float64, so that what is compared is the program's summation and its
terms, each vertex's gap as a share of the mass of what was added there
(``step_gaps``); at the hubs, whose springs the program sums in long runs
of block sums, the same gap is also taken as a share of that mass without
the mean's share (``LayoutReference.term_scale``).

The start: the Chebyshev-filtered subspace iteration of
``ops/laplacian.py`` (the same start block from
``np.random.default_rng(seed)``, the same filter, degree, rounds and
cutoff rule) on a plain sparse matrix, or the random start.
"""

import numpy as np
import torch

from .binfold import knn_binfold

EPS = 1e-6
# the share of a vertex's mass that the repulsions an exact kNN tie leaves
# open may reach before the vertex is left out of the comparison
OPEN_SHARE = 1e-6


# a hub: a vertex of at least this many edges (its springs take long runs
# of block sums in the program's static sum)
HUB_DEGREE = 1024
# the sample rule (``graphem_rapids_torch/ops/sampling.py``), frozen: below
# this many edges a random permutation cut to size, from it on the top S
# of iid uniforms
FAST_SAMPLE_MIN_EDGES = 1 << 18


def check_sample(sample, n_edges, size):
    """Whether ``sample`` is ``size`` distinct edge ids in [0, n_edges)."""
    s = np.asarray(sample, np.int64)
    return (s.shape == (min(size, n_edges),) and int(s.min()) >= 0
            and int(s.max()) < n_edges and len(np.unique(s)) == len(s))


class SampleDraws:
    """The engine's sample draws, drawn again: draw i is the i-th call of
    the sample rule on a ``torch.Generator`` on ``device`` seeded with
    ``seed``, as the engine's generator gives it (one draw an iteration,
    eager or replayed: a replay advances the generator as an eager draw
    does)."""

    def __init__(self, seed, n_edges, size, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.n, self.size, self.device = int(n_edges), int(size), device
        self.drawn = 0

    def _draw(self):
        self.drawn += 1
        if self.n >= FAST_SAMPLE_MIN_EDGES:
            return torch.rand(self.n, generator=self.gen, device=self.device)
        return torch.randperm(self.n, generator=self.gen, device=self.device)

    def matches(self, index, sample):
        """Whether ``sample`` is draw ``index`` (indices ascending): the
        first S of the permutation as a set, or a top S of the uniforms,
        where a tie at the S-th value may take any of the tied."""
        if self.drawn > index:
            raise ValueError("draws are checked in ascending order")
        s = torch.as_tensor(np.asarray(sample, np.int64), device=self.device)
        if not check_sample(s.cpu().numpy(), self.n, self.size):
            return False
        if self.size >= self.n:
            return True
        while self.drawn < index:
            self._draw()
        x = self._draw()
        if self.n < FAST_SAMPLE_MIN_EDGES:
            want = torch.sort(x[:self.size]).values
            return bool(torch.equal(torch.sort(s).values, want))
        kth = torch.topk(x, self.size).values.min()
        above = int((x > kth).sum())
        return bool((x[s] >= kth).all()) and int((x[s] > kth).sum()) == above


def _orientation(a, b, c):
    return ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))


class LayoutReference:
    """The graph's ref space and edges on ``device``, and the step."""

    def __init__(self, space, e0, e1, engine):
        self.space = space
        self.e0, self.e1 = e0, e1  # user edges, user vertex ids
        self.k_attr = float(engine["k_attr"])
        self.L_min = float(engine["L_min"])
        self.k_inter = float(engine["k_inter"])
        self.k = int(engine["n_neighbors"]) + 1
        self.recall = float(engine.get("knn_recall_target", 0.95))
        # internal edge -> its endpoints as user ids, lower internal first
        self.i0, self.i1 = space.perm[space.lo], space.perm[space.hi]
        self.pad = space.ref_edge < 0

    def _repulsion(self, P, ci, cj):
        """[(vertex ids, terms)] of the repulsion of the candidate pairs
        (ci, cj) of internal edge ids, in P's precision: zero unless user
        edge id ci < cj, no shared vertex and a proper crossing."""
        eu = self.space.edge_user
        valid = (eu[ci] < eu[cj]) & (cj >= 0)
        cj = cj.clamp(min=0)
        a0, a1 = self.i0[ci], self.i1[ci]
        b0, b1 = self.i0[cj], self.i1[cj]
        share = (a0 == b0) | (a0 == b1) | (a1 == b0) | (a1 == b1)
        p1, p2, q1, q2 = P[a0], P[a1], P[b0], P[b1]
        crosses = ((_orientation(p1, p2, q1) * _orientation(p1, p2, q2) < 0)
                   & (_orientation(q1, q2, p1) * _orientation(q1, q2, p2)
                      < 0))
        w = (valid & ~share & crosses).to(P.dtype)[:, None]
        m = (p1 + p2 + q1 + q2) / 4.0
        out = []
        for ids, x in ((a0, p1), (a1, p2), (b0, q1), (b1, q2)):
            dv = x - m
            dd = torch.linalg.vector_norm(dv, dim=1, keepdim=True) + EPS
            out.append((ids, w * (self.k_inter * dv / (dd ** 2))))
        return out

    def step(self, positions, sampled, dtype=torch.float32):
        """(next positions, scale), both (n, d) float64 in user order, from
        float32 ``positions`` (n, d, user order) and the sampled internal
        edge ids (S,). Every term, and the neighbours, in ``dtype``; every
        sum in float64. ``scale`` is each value's mass: the magnitudes of
        the start and of every term added to it, and the mean magnitude
        over the vertices (the mean taken off is a sum of them), over the
        std it is divided by."""
        sp = self.space
        P = positions.to(torch.float32).to(dtype)
        dev = P.device
        acc = P.double().clone()
        mass = acc.abs()

        def add(ids, terms):
            t = terms.double()
            acc.index_add_(0, ids, t)
            mass.index_add_(0, ids, t.abs())

        diff = P[self.e1] - P[self.e0]
        dist = torch.linalg.vector_norm(diff, dim=1, keepdim=True) + EPS
        f = (-self.k_attr * (dist - self.L_min)) * (diff / dist)
        add(self.e0, f)
        add(self.e1, -f)

        sampled = sampled.to(dev).long()
        mid = (P[self.i0] + P[self.i1]) * 0.5
        refs = mid[sp.ref_edge.clamp(min=0)]
        k = self.k
        pos, v, (cand_v, cand_p) = knn_binfold(
            mid[sampled], refs, self.pad, k, recall_target=self.recall,
            dtype=dtype, extra=1)
        nbr = sp.ref_edge[pos[:, 1:k]]
        for ids, t in self._repulsion(P, sampled.repeat_interleave(k - 1),
                                      nbr.reshape(-1)):
            add(ids, t)

        # An exact tie at the top (which column is the midpoint itself) or
        # at the k-th rank leaves the rule's choice open among the tied
        # candidates: every pair of such a query's edge with a candidate up
        # to the tie could be the program's. A vertex where those pairs'
        # repulsions could add more than OPEN_SHARE of its mass is left out
        # of the comparison; at every other vertex they join its mass.
        open_q = torch.nonzero((v[:, 0] == v[:, 1])
                               | (v[:, k - 1] == v[:, k])).flatten()
        row, col = torch.nonzero(cand_v[open_q] <= v[open_q, k - 1:k],
                                 as_tuple=True)
        cj = sp.ref_edge[cand_p[open_q][row, col].clamp(min=0)]
        alt = torch.zeros_like(mass)
        for ids, t in self._repulsion(P, sampled[open_q][row], cj):
            alt.index_add_(0, ids, t.double().abs())
        self.open_vertices = torch.nonzero(
            (alt > OPEN_SHARE * mass).any(dim=1)).flatten()
        mass += alt

        mean = acc.mean(dim=0, keepdim=True)
        new = acc - mean
        std = new.std(dim=0, keepdim=True, unbiased=True) + EPS
        self.term_scale = mass / std
        # the mean is a sum over every vertex: its rounding is a share of
        # the mean magnitude, and it reaches every vertex
        return new / std, (mass + acc.abs().mean(dim=0, keepdim=True)) / std


def step_gaps(got, want, scale, left_out=None):
    """Each vertex's largest gap over its coordinates, each coordinate's
    gap as a share of its mass (``LayoutReference.step``'s scale): where a
    value is a sum of many or of large terms, or near a cancellation, the
    rounding of a correct sum is a share of the terms, not of the sum.
    The vertices ``left_out`` (the step's ``open_vertices``) read 0."""
    gap = ((got.double() - want).abs() / (scale + EPS)).max(dim=1).values
    if left_out is not None:
        gap[left_out] = 0.0
    return gap


def random_start(n, n_components, seed):
    """The random start: 0.1 * standard normals from the seed, float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n_components)) * 0.1).astype(np.float32)


def chebyshev_start(indptr, indices, n_components, seed, device,
                    dtype=torch.float64, n_outer=8, degree=14, guard=4):
    """(X, ritz): the n_components + 1 + guard columns of the
    Chebyshev-filtered subspace iteration for the low end of the
    normalized Laplacian, Ritz-ordered (the start is the first
    n_components), and their Ritz values, in ``dtype`` (bfloat16 is held
    in bfloat16 between operations and computed in float32)."""
    n = len(indptr) - 1
    s = n_components + 1 + guard
    compute = torch.float64 if dtype == torch.float64 else torch.float32

    def held(x):
        return x if dtype == compute else x.to(dtype).to(compute)

    crow = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    col = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   crow[1:] - crow[:-1],
                                   output_size=col.shape[0])
    keep = rows != col
    rows, col = rows[keep], col[keep]
    deg = torch.bincount(rows, minlength=n).to(compute)
    dinv = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
    sq = torch.sqrt(deg)
    v0 = sq / (torch.linalg.vector_norm(sq) + 1e-30)

    def lap(X):
        Y = dinv[:, None] * X
        AY = torch.zeros_like(X).index_add_(0, rows, Y[col])
        return held(X - dinv[:, None] * AY)

    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.standard_normal((n, s)).astype(np.float32),
                        device=device).to(compute)
    a = torch.tensor(0.5, dtype=compute, device=device)
    for _ in range(n_outer):
        e, c = (2.0 + a) / 2.0, (2.0 - a) / 2.0
        Y_prev, Y = X, held((lap(X) - e * X) / c)
        for _ in range(degree - 1):
            Y_prev, Y = Y, held((2.0 / c) * (lap(Y) - e * Y) - Y_prev)
        X = held(Y - v0[:, None] * (v0 @ Y))
        X, _ = torch.linalg.qr(X)
        H = X.T @ lap(X)
        ritz, W = torch.linalg.eigh((H + H.T) / 2.0)
        X = held(X @ W)
        a = torch.clamp(ritz[n_components], 0.05, 1.9)
    return X, ritz


def subspace_gap(program_cols, reference_cols):
    """||X - Q Q^T X||_F / ||X||_F: how far the program's columns X lie
    outside the span Q of the reference's.

    The start is compared against the span of the reference's first
    n_components + 1 columns: where the n_components-th and the next
    eigenvalue lie close, any mix of their vectors is as good a start, and
    rounding alone turns one into the other; rounding noise of a lower
    precision lies outside any few columns of the n-dimensional space.
    """
    X = program_cols.to(torch.float64)
    Q, _ = torch.linalg.qr(reference_cols.to(torch.float64))
    R = X - Q @ (Q.T @ X)
    return float(torch.linalg.norm(R) / torch.linalg.norm(X))
