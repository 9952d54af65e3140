"""The scatter-form IC cascade of the PyTorch port (``ops/ic_scatter.py``):
its plain version against JAX's ``_ic_run``, against the gather form's
plain version, against an independent numpy cascade that draws the same
coins, and at any edge chunking.

The scatter form runs over the directed edge list ``src = [e0; e1]``,
``dst = [e1; e0]``; the coin of directed edge e for column b at step t is
the gather form's ``coin(t, dst[e], e, b)``, a function of (t, e, b) and
the key alone. The plain version is what the wrapper runs for CPU tensors.
The CUDA kernel (``csrc/ic_scatter.cu``) is held against it, bit for bit,
by the tests marked ``cuda``, which need a card (the card's machine has
no JAX, so run them without the conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_ic_scatter.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_cascade as icc
from graphem_rapids_torch.ops import ic_scatter as ics
from graphem_rapids_torch.ops import ic_sim as tic
from test_torch_ic_cascade import _np_coins


def _hub_edges(n=300, seed=0, hubs=(70, 40), chords=150):
    """A ring of n vertices, hubs 0 and 1 with ``hubs`` random neighbours,
    and ``chords`` random chords: (E, 2) int64 with i < j."""
    rng = np.random.default_rng(seed)
    e = [(j, (j + 1) % n) for j in range(n)]
    for hub, size in enumerate(hubs):
        e += [(hub, int(u)) for u in rng.choice(np.arange(2, n), size, False)]
    e += [tuple(int(x) for x in p) for p in rng.integers(0, n, (chords, 2))]
    e = {tuple(sorted(p)) for p in e if p[0] != p[1]}
    return np.array(sorted(e), np.int64), n


def _split_edges(seed=2):
    """Three components (a ring of 150 with chords, a path of 90, a star
    of 40) and 20 isolated vertices, labels shuffled: 300 vertices."""
    rng = np.random.default_rng(seed)
    e = [(j, (j + 1) % 150) for j in range(150)]
    e += [tuple(p) for p in rng.integers(0, 150, (40, 2))]
    e += [(150 + j, 151 + j) for j in range(89)]
    e += [(240, 241 + j) for j in range(39)]
    perm = rng.permutation(300)
    e = {tuple(sorted((int(perm[a]), int(perm[b])))) for a, b in e if a != b}
    return np.array(sorted(e), np.int64), 300


def _seed_mask(n, B, per_col=3, seed=1):
    """(n, B) bool, ``per_col`` random seeds in each column."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, B), bool)
    for b in range(B):
        mask[rng.choice(n, per_col, replace=False), b] = True
    return mask


def _key(k=(0x12345678, 0x9ABCDEF0), device="cpu"):
    return torch.as_tensor(np.asarray(k, np.int64), device=device)


def _scatter(edges, mask, thr, max_iters, device="cpu", chunk=None,
             stats=None, runs=None):
    src, dst = tic.directed_edges(edges, device)
    words = icc.pack_columns(torch.as_tensor(mask, device=device))
    return ics.ic_scatter_reference(src, dst, words, _key(device=device),
                                    thr, max_iters, mask.shape[1], runs,
                                    stats=stats, chunk=chunk)


def _np_scatter(edges, seed, key, thr, max_iters, runs=None):
    """Independent numpy scatter cascade on (n, B) bool state: every
    directed edge whose source is in the frontier draws its coin, column
    b as run b mod ``runs`` (None: every column its own)."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    active, frontier, steps = seed.copy(), seed.copy(), 0
    for t in range(max_iters):
        e, b = np.nonzero(frontier[src])
        r = b if runs is None else b % runs
        fire = _np_coins(t, dst[e].astype(np.uint64), e.astype(np.uint64),
                         r.astype(np.uint64), key, thr)
        hit = np.zeros_like(active)
        hit[dst[e][fire], b[fire]] = True
        newly = hit & ~active
        active |= newly
        frontier = newly
        steps += 1
        if not newly.any():
            break
    return active, steps


def _components(edges, n):
    a = sp.coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                      shape=(n, n))
    return connected_components(a, directed=False)[1]


@pytest.mark.fast
@pytest.mark.parametrize("form", ["hub", "int64", "tensor", "empty"])
def test_directed_edges_are_jax_order(form):
    edges, n = _hub_edges()
    if form == "empty":
        edges = edges[:0]
    given = {"int64": edges.astype(np.int64),
             "tensor": torch.as_tensor(edges)}.get(form, edges)
    src, dst = tic.directed_edges(given, "cpu")
    assert src.dtype == dst.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), np.r_[edges[:, 0],
                                                     edges[:, 1]])
    np.testing.assert_array_equal(dst.numpy(), np.r_[edges[:, 1],
                                                     edges[:, 0]])


@pytest.mark.fast
@pytest.mark.parametrize("B", [1, 33, 64, 100])
@pytest.mark.parametrize("p,max_iters", [(0.3, 200), (0.6, 3), (1.0, 200)])
def test_plain_matches_numpy_cascade(B, p, max_iters):
    edges, n = _hub_edges()
    seed = _seed_mask(n, B)
    key = (0x12345678, 0x9ABCDEF0)
    thr = icc.coin_threshold(p)
    want, want_steps = _np_scatter(edges, seed, key, thr, max_iters)
    active, counts, steps = _scatter(edges, seed, thr, max_iters)
    assert torch.equal(icc.unpack_columns(active, B), torch.as_tensor(want))
    np.testing.assert_array_equal(counts.numpy(), want.sum(axis=0))
    assert counts.dtype == torch.int32 and counts.shape == (B,)
    assert int(steps) == want_steps
    if max_iters == 3:
        assert want_steps == 3


@pytest.mark.fast
@pytest.mark.parametrize("B,runs", [(100, 30), (96, 32), (64, 1), (70, 7),
                                    (40, 40)])
def test_runs_share_coins(B, runs):
    """Column b draws the coins of run b mod runs: the plain version
    equals the numpy cascade that draws so, runs = B equals the default,
    and columns runs apart that hold the same seeds give the same run."""
    edges, n = _hub_edges()
    seed = _seed_mask(n, runs)[:, np.arange(B) % runs]
    key = (0x12345678, 0x9ABCDEF0)
    thr = icc.coin_threshold(0.3)
    want, want_steps = _np_scatter(edges, seed, key, thr, 200, runs)
    active, counts, steps = _scatter(edges, seed, thr, 200, runs=runs)
    assert torch.equal(icc.unpack_columns(active, B), torch.as_tensor(want))
    assert int(steps) == want_steps
    c = counts.numpy()
    np.testing.assert_array_equal(c, c[np.arange(B) % runs])
    if runs == B:
        for g, w in zip(_scatter(edges, seed, thr, 200), (active, counts,
                                                          steps)):
            assert torch.equal(g, w)
    else:  # independent coins give the groups different runs
        free = _scatter(edges, seed, thr, 200)[1].numpy()
        assert (free != free[np.arange(B) % runs]).any()


@pytest.mark.fast
@pytest.mark.parametrize("p", [0.1, 0.5, 1.0])
def test_edge_chunks_change_nothing(p):
    """Chunks of 1, 7 and all directed edges: identical words, counts and
    steps, so a coin depends on (t, e, b) alone, as the kernel needs."""
    edges, n = _hub_edges(n=60, seed=3, hubs=(15, 8), chords=10)
    seed = _seed_mask(n, 40, per_col=2)
    thr = icc.coin_threshold(p)
    runs = [_scatter(edges, seed, thr, 200, chunk=c)
            for c in (1, 7, 2 * len(edges))]
    for got in runs[1:]:
        for g, w in zip(got, runs[0]):
            assert torch.equal(g, w)
    assert int(runs[0][2]) >= 2


@pytest.mark.fast
@pytest.mark.parametrize("p,max_iters", [(0.0, 200), (0.3, 200), (0.6, 3),
                                         (1.0, 200)])
@pytest.mark.parametrize("chunk", [7, None])
def test_attempted_counts_edges_behind_the_frontier(p, max_iters, chunk):
    """stats['attempted'] (the dst reads in chip_smoke.py's bound) is the
    number of directed edges whose source was in the frontier, in some
    column, at some step: the sources active after all but the last step
    (whose frontier is the empty newly, or is left unswept at the cap)."""
    edges, n = _hub_edges()
    seed = _seed_mask(n, 40)
    thr = icc.coin_threshold(p)
    stats = {}
    steps = _scatter(edges, seed, thr, max_iters, chunk=chunk,
                     stats=stats)[2]
    swept = _scatter(edges, seed, thr, int(steps) - 1)[0]
    src, _ = tic.directed_edges(edges, "cpu")
    want = int((swept != 0).any(dim=1)[src.long()].sum())
    assert stats["attempted"] == want
    assert 0 < want <= src.shape[0]
    if p == 1.0:  # the graph is connected: every edge is tried
        assert want == src.shape[0]


@pytest.mark.fast
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_scatter_equals_gather_exactly(p):
    """At p=0 and p=1 the cascade is not random: the scatter and gather
    plain versions give the same words, counts and steps (a BFS at p=1)."""
    edges, n = _split_edges()
    seed = _seed_mask(n, 70, per_col=2, seed=4)
    thr = icc.coin_threshold(p)
    got = _scatter(edges, seed, thr, 200)
    plan = tic.build_cascade_plan(edges, n, "cpu")
    want = icc.ic_cascade_reference(
        plan["table"], plan["ov_ptr"], plan["ov_src"],
        icc.pack_columns(torch.as_tensor(seed)), _key(), thr, 200, 70)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    comp = _components(edges, n)
    exact = [len(seed[:, b].nonzero()[0]) if p == 0 else
             int(np.isin(comp, comp[seed[:, b]]).sum()) for b in range(70)]
    np.testing.assert_array_equal(got[1].numpy(), exact)


@pytest.mark.fast
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_exact_against_jax_ic_run(p):
    jic = pytest.importorskip("graphem_rapids_tpu.ops.ic_sim")
    jax = pytest.importorskip("jax")
    edges, n = _split_edges()
    seeds = [5, 77, 201]
    mask = np.zeros(n, bool)
    mask[seeds] = True
    src, dst = (np.r_[edges[:, 0], edges[:, 1]].astype(np.int32),
                np.r_[edges[:, 1], edges[:, 0]].astype(np.int32))
    want = np.asarray(jic._ic_run(src, dst, mask, p, jax.random.PRNGKey(3),
                                  n, 16, 200))
    got = _scatter(edges, np.repeat(mask[:, None], 16, axis=1),
                   icc.coin_threshold(p), 200)[1].numpy()
    np.testing.assert_array_equal(got, want)
    comp = _components(edges, n)
    assert (got == (3 if p == 0 else np.isin(comp, comp[seeds]).sum())).all()


@pytest.mark.fast
def test_mean_spread_matches_jax_ic_run(monkeypatch):
    """At p=0.1, 512 runs a side: mean spreads within 4 standard errors of
    the difference (the tolerance of test_mean_spread_matches_jax)."""
    jic = pytest.importorskip("graphem_rapids_tpu.ops.ic_sim")
    jax = pytest.importorskip("jax")
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    edges, n = _hub_edges(n=400, seed=5)
    seeds = [3, 77, 150, 301, 388]
    mask = np.zeros(n, bool)
    mask[seeds] = True
    src, dst = (np.r_[edges[:, 0], edges[:, 1]].astype(np.int32),
                np.r_[edges[:, 1], edges[:, 0]].astype(np.int32))
    jc = np.asarray(jic._ic_run(src, dst, mask, 0.1, jax.random.PRNGKey(11),
                                n, 512, 200), float)
    tc, _ = tic.independent_cascade(edges, n, seeds, p=0.1, num_sims=512,
                                    key=11, device="cpu")
    tc = tc.astype(float)
    se = np.sqrt(jc.var(ddof=1) / len(jc) + tc.var(ddof=1) / len(tc))
    assert abs(jc.mean() - tc.mean()) < 4 * se, (jc.mean(), tc.mean(), se)
    assert tc.min() >= len(seeds)


@pytest.mark.fast
def test_independent_cascade_takes_one_scatter_call(monkeypatch):
    """Past the table budget independent_cascade makes one ic_scatter call
    per cascade on the int32 edge list, with a key from the caller's
    generator, and no ic_cascade call; the edges' push lists go with it
    where the kernel reads them (a card; here made to), and not to the
    plain version on the CPU."""
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    edges, n = _hub_edges()
    calls = []
    real = tic.ic_scatter

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(tic, "ic_scatter", counted)
    monkeypatch.setattr(tic, "ic_cascade", None)
    counts, _ = tic.independent_cascade(edges, n, [4, 9], p=0.2,
                                        num_sims=70, key=9, device="cpu")
    assert len(calls) == 1
    (src, dst, words, key, thr, max_iters, cols, runs), kwargs = calls[0]
    # the plain version on the CPU: no push lists, no launch stats
    assert kwargs == {"lists": None, "stats": None}
    assert src.dtype == dst.dtype == torch.int32 and src.shape == (
        2 * len(edges),)
    assert words.shape == (n, 3) and (thr, max_iters, cols, runs) == (
        icc.coin_threshold(0.2), 200, 70, None)
    gen = torch.Generator().manual_seed(9)
    want = ics.ic_scatter_reference(src, dst, words, icc.draw_key(gen), thr,
                                    200, 70)[1]
    np.testing.assert_array_equal(counts, want.numpy())
    again, _ = tic.independent_cascade(edges, n, [4, 9], p=0.2, num_sims=70,
                                       key=torch.Generator().manual_seed(9),
                                       device="cpu")
    np.testing.assert_array_equal(again, counts)
    monkeypatch.setattr(tic, "wants_push_lists", lambda device: True)
    again, _ = tic.independent_cascade(edges, n, [4, 9], p=0.2, num_sims=70,
                                       key=9, device="cpu")
    np.testing.assert_array_equal(again, counts)
    assert len(calls) == 3
    for got, want in zip(calls[2][1]["lists"],
                         ics.edge_push_lists(src, dst, n)):
        assert torch.equal(got, want)


@pytest.mark.fast
def test_depth_cap_and_stop():
    ring = np.array([(j, j + 1) for j in range(59)] + [(0, 59)], np.int64)
    one = np.zeros((60, 2), bool)
    one[0] = True
    thr = icc.coin_threshold(1.0)
    # a ring walked at p=1 from one vertex gains two vertices per step
    active, counts, steps = _scatter(ring, one, thr, 3)
    assert counts.tolist() == [7, 7] and int(steps) == 3
    active, counts, steps = _scatter(ring, one, thr, 200)
    assert counts.tolist() == [60, 60] and int(steps) == 31
    for more in (31, 32, 1000):
        a, c, st = _scatter(ring, one, thr, more)
        assert torch.equal(a, active) and int(st) == 31
    a, c, st = _scatter(ring, one, thr, 0)
    assert int(st) == 0 and c.tolist() == [1, 1]
    assert torch.equal(a, icc.pack_columns(torch.as_tensor(one)))
    # no seed: one step, nothing active
    a, c, st = _scatter(ring, np.zeros((60, 2), bool), thr, 200)
    assert int(st) == 1 and c.tolist() == [0, 0]


@pytest.mark.fast
def test_wrapper_rejects_bad_inputs():
    edges, n = _hub_edges()
    src, dst = tic.directed_edges(edges, "cpu")
    words = icc.pack_columns(torch.as_tensor(_seed_mask(n, 40)))
    key = _key()
    good = (src, dst, words, key, 100, 10, 40)
    ics.ic_scatter(*good)

    def bad(i, value):
        args = list(good)
        args[i] = value
        return args

    with pytest.raises(TypeError):
        ics.ic_scatter(*bad(0, src.long()))
    with pytest.raises(TypeError):
        ics.ic_scatter(*bad(1, dst.long()))
    with pytest.raises(TypeError):
        ics.ic_scatter(*bad(2, words.bool()))
    with pytest.raises(TypeError):
        ics.ic_scatter(*bad(3, key.int()))
    with pytest.raises(ValueError, match="W"):
        ics.ic_scatter(*bad(6, 65))  # 65 columns need 3 words
    with pytest.raises(ValueError, match="W"):
        ics.ic_scatter(*bad(2, words[:, :1].contiguous()))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(1, dst[:-1]))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(0, src.reshape(2, -1)))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(3, key[:1]))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(4, 2**32 + 1))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(5, -1))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(6, 0))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(0, torch.stack([src, src], dim=1)[:, 0]))
    with pytest.raises(ValueError):
        ics.ic_scatter(*bad(2, words.t().contiguous().t()))
    with pytest.raises(ValueError, match="runs"):
        ics.ic_scatter(*good, 0)
    with pytest.raises(ValueError, match="runs"):
        ics.ic_scatter(*good, 41)
    # 2E and n * W at 2^31, by shape alone (meta tensors hold no data)
    meta = dict(dtype=torch.int32, device="meta")
    big = torch.empty(2**31, **meta)
    with pytest.raises(ValueError, match="2E"):
        ics.ic_scatter(big, big, torch.empty((n, 2), **meta),
                       key.to("meta"), 100, 10, 64)
    small = torch.empty(8, **meta)
    with pytest.raises(ValueError, match="n \\* W"):
        ics.ic_scatter(small, small, torch.empty((2**26, 32), **meta),
                       key.to("meta"), 100, 10, 1024)
    with pytest.raises(ValueError):
        ics.ic_scatter_cuda(*good)  # CPU tensors never reach the kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scatter kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,runs", [(1, None), (33, None), (64, None),
                                    (2048, None), (2048, 32), (100, 30),
                                    (33, 1)])
@pytest.mark.parametrize("p,max_iters", [(0.0, 200), (0.3, 200), (0.6, 3),
                                         (1.0, 200), (0.3, 0)])
def test_kernel_matches_plain(cuda_device, B, runs, p, max_iters):
    edges, n = _hub_edges()
    seed = _seed_mask(n, B)
    thr = icc.coin_threshold(p)
    src, dst = tic.directed_edges(edges, cuda_device)
    words = icc.pack_columns(torch.as_tensor(seed, device=cuda_device))
    key = _key((0xDEADBEEF, 0x01234567), cuda_device)
    launches = ics.ic_scatter.launches
    got = ics.ic_scatter(src, dst, words, key, thr, max_iters, B, runs,
                         ics.edge_push_lists(src, dst, n))
    torch.cuda.synchronize()
    assert ics.ic_scatter.launches == launches + 1
    want = ics.ic_scatter_reference(src, dst, words, key, thr, max_iters, B,
                                    runs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_greedy_scatter_card_equals_cpu(cuda_device, monkeypatch):
    """The full sweep through the kernel picks the CPU's seeds on the
    two-star graph (p=1: no randomness), one launch per chunk."""
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    e = [(0, j) for j in range(1, 201)] + [(201, j) for j in range(202, 252)]
    edges = np.array(e, np.int64)
    launches = ics.ic_scatter.launches
    card, evals = tinf.greedy_seed_selection((edges, 252), 2, p=1.0,
                                             num_sims=4)
    assert ics.ic_scatter.launches - launches == 2  # one chunk a round
    cpu, cpu_evals = tinf.greedy_seed_selection((edges, 252), 2, p=1.0,
                                                num_sims=4, device="cpu")
    assert card == cpu == [0, 201] and evals == cpu_evals
