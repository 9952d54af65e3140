"""A plain model of the IC kernels' frontier-driven step, and their push
lists.

Both cascade kernels (``csrc/ic_cascade.cu``, gather form, and
``csrc/ic_scatter.cu``, scatter form) run ``csrc/ic_common.cuh``'s step,
one grid barrier a step. Step t ORs its fired coins into hit buffer t % 3;
a hit holds only columns not yet active, so buffer (t - 1) % 3 is the
frontier of step t at every vertex. The vertices with a frontier word not
zero are the queue Q_t, a list of vertices with each one's first pair
(the exclusive prefix of its out-degree in the push lists); the lists
rotate by t % 3 too. A push step hands the queue's pairs out by those
offsets (a search of the offsets finds the vertex of pair g, so a hub's
row spreads over many warps) and appends each receiver it hits first (a
step stamp) to the touched list T_t, in whatever order the warps reach
it; a dense step walks the form's whole graph (the table, or every
directed edge) and appends the same way. In the same pass active |=
hit_{t - 1} over Q_t, and hit_{t - 2} is cleared over T_{t - 2}; T_t is
Q_{t + 1}. The cascade stops before a step whose queue is empty (step 0
aside), and the last step's hits are folded into active at the end. A
step is dense where Q_t's pairs pass the limit.

``_Model`` replays that schedule in torch on the CPU, the lists in a
seeded shuffled order, and asserts its invariants every step (the queue
is the frontier's vertices, the offsets find every pair in its own row,
the buffer a step writes is clear, a hit is never active). Its active
words, counts and steps must equal the plain versions'
(``ic_cascade_reference``, ``ic_scatter_reference``) bit for bit, in push,
dense and switching schedules, and its pairs per step the plain versions'
``step_pairs``. The push lists are held against a numpy construction. The
kernels themselves are held against the plain versions in every mode on
the card by the tests marked ``cuda`` (run without the conftest on the
card's machine, which has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_ic_frontier.py
"""

import numpy as np
import pytest
import torch

from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_cascade as icc
from graphem_rapids_torch.ops import ic_scatter as ics
from graphem_rapids_torch.ops import ic_sim as tic

KEY = (0x2545F491, 0x6C078965)


def _graph(n=150, seed=0, hubs=(40, 25), chords=60, isolated=4, loop=True):
    """A ring over the first n - isolated vertices, hubs 0 and 1 with
    ``hubs`` random neighbours (their in-edges overflow the table), random
    chords, the last ``isolated`` vertices on no edge, and a self-loop at
    vertex 5: (E, 2) int64 edges with i <= j, and n."""
    rng = np.random.default_rng(seed)
    m = n - isolated
    e = [(j, (j + 1) % m) for j in range(m)]
    for hub, size in enumerate(hubs):
        e += [(hub, int(u)) for u in rng.choice(np.arange(2, m), size, False)]
    e += [tuple(int(x) for x in p) for p in rng.integers(0, m, (chords, 2))]
    e = {tuple(sorted(p)) for p in e if p[0] != p[1]}
    if loop:
        e.add((5, 5))
    return np.array(sorted(e), np.int64).reshape(-1, 2), n


def _np_push(src, recv, slot, n):
    """Push lists in numpy: the triples whose source is not their receiver,
    stably sorted by source, and the row starts."""
    keep = src != recv
    src, recv, slot = src[keep], recv[keep], slot[keep]
    order = np.argsort(src, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    return ptr, recv[order], slot[order]


def _np_table_triples(arrays):
    table, ov_ptr, ov_src = arrays["table"], arrays["ov_ptr"], arrays["ov_src"]
    n, cap = table.shape
    src = np.concatenate([table.reshape(-1), ov_src]).astype(np.int64)
    recv = np.concatenate([np.repeat(np.arange(n), cap),
                           np.repeat(np.arange(n), np.diff(ov_ptr))])
    slot = np.concatenate([np.tile(np.arange(cap), n),
                           cap + np.arange(len(ov_src))])
    return src, recv, slot


def _assert_int32(lists):
    for x in lists:
        assert x.dtype == torch.int32 and x.is_contiguous()


GRAPHS = {
    "hubs_isolated_loop": lambda: _graph(),
    "regular": lambda: _graph(n=120, seed=3, hubs=(), chords=120,
                              isolated=0, loop=False),
    "empty": lambda: (np.zeros((0, 2), np.int64), 10),
}


def _assert_lists_equal(got, want, n, self_slots):
    """``got`` (int32 lists) equals the numpy lists ``want`` in every row,
    and holds exactly ``self_slots`` past its last row."""
    _assert_int32(got)
    P = int(got[0][-1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy()[:P], want[1])
    np.testing.assert_array_equal(got[2].numpy()[:P], want[2])
    assert got[0].shape == (n + 1,)
    assert sorted(got[2].numpy()[P:].tolist()) == sorted(self_slots)


@pytest.mark.fast
@pytest.mark.parametrize("chunk", [1 << 24, 7])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_push_lists_equal_numpy(monkeypatch, name, chunk):
    """Both forms' lists against numpy's stable sort by source, built in
    one sort and in sorts of 7 triples."""
    monkeypatch.setattr(icc, "PUSH_SORT_CHUNK", chunk)
    edges, n = GRAPHS[name]()
    arrays = tic.cascade_plan_arrays(edges, n)
    if name == "hubs_isolated_loop":
        assert len(arrays["ov_src"]) > 0
    plan = tic.upload_plan(arrays, "cpu")
    got = icc.table_push_lists(plan["table"], plan["ov_src"], plan["ov_dst"],
                               plan["ov_ptr"])
    src, recv, slot = _np_table_triples(arrays)
    _assert_lists_equal(got, _np_push(src, recv, slot, n), n,
                        slot[src == recv].tolist())
    directed = tic.directed_edges(edges, "cpu")
    src, dst = (a.numpy() for a in directed)
    got = ics.edge_push_lists(*directed, n)
    loops = np.flatnonzero(src == dst)
    _assert_lists_equal(got, _np_push(src.astype(np.int64),
                                      dst.astype(np.int64),
                                      np.arange(len(src)), n), n,
                        loops.tolist())
    # a row is a source's pairs: P = 2E less the self-loop's two directions
    assert int(got[0][-1]) == 2 * len(edges) - len(loops)
    if name == "hubs_isolated_loop":
        ptr = got[0].numpy()
        assert len(loops) == 2
        assert (np.diff(ptr)[n - 4:] == 0).all()  # the isolated vertices
        assert 5 not in got[1].numpy()[ptr[5]:ptr[6]]


@pytest.mark.fast
def test_plan_carries_its_push_lists(monkeypatch):
    """A plan for a card carries its lists, built once with the plan (here
    made to, on the CPU); a plan for the CPU, whose plain version reads
    none, carries none."""
    edges, n = _graph()
    assert "push" not in tic.build_cascade_plan(edges, n, "cpu")
    monkeypatch.setattr(tic, "wants_push_lists", lambda device: True)
    builds = icc.push_lists.builds
    plan = tic.build_cascade_plan(edges, n, "cpu")
    assert icc.push_lists.builds == builds + 1
    want = icc.table_push_lists(plan["table"], plan["ov_src"],
                                plan["ov_dst"], plan["ov_ptr"])
    for g, w in zip(plan["push"], want):
        assert torch.equal(g, w)


class _Model:
    """The kernels' schedule on (n, 32 W) bool state (see the module
    docstring). ``dense_limit``: a step whose queue has more pairs is
    dense; ``modes`` and ``pairs`` record each step's mode and pairs."""

    def __init__(self, lists, triples, n, W, key, thr, runs, dense_limit,
                 order_seed=0):
        self.ptr, self.recv, self.slot = (x.long() for x in lists)
        self.deg = self.ptr[1:] - self.ptr[:-1]
        self.triples = triples  # the dense pass's (src, recv, slot)
        self.n, self.W = n, W
        self.key = torch.as_tensor(np.asarray(key, np.int64))
        self.thr, self.runs = thr, runs
        self.limit = dense_limit
        self.rng = np.random.default_rng(order_seed)
        self.modes, self.pairs = [], []

    def _shuffled(self, vertices):
        """A list in an order the warps might append it."""
        return vertices[torch.as_tensor(self.rng.permutation(
            vertices.shape[0]), dtype=torch.long)]

    def _fire(self, t, u, v, slot, frontier, active, hit):
        """OR into hit the coins that fire for attempts (u -> v, slot)."""
        cand = frontier[u] & ~active[v]
        e, b = torch.nonzero(cand, as_tuple=True)
        fire = icc.coin_fires(t, v[e], slot[e], b % self.runs, self.key,
                              self.thr)
        hit[v[e][fire], b[fire]] = True

    def run(self, seed_words, max_iters):
        n = self.n
        active = icc.unpack_columns(seed_words, 32 * self.W)
        # hit of step t in buffer t % 3; buffer 2 starts as the seed words,
        # the frontier of step 0
        hits = [torch.zeros_like(active), torch.zeros_like(active),
                active.clone()]
        lists = [None, None,
                 self._shuffled(torch.nonzero(active.any(dim=1))[:, 0])]
        stamp = torch.full((n,), -1, dtype=torch.long)
        t = 0
        while t < max_iters:
            cur, prev, old = t % 3, (t + 2) % 3, (t + 1) % 3
            queue, frontier, hit = lists[prev], hits[prev], hits[cur]
            if t > 0 and queue.shape[0] == 0:
                break  # step t - 1 activated no one
            # the queue is the frontier's vertices, each once; the buffer
            # this step writes is clear; a frontier bit is not yet folded
            assert sorted(queue.tolist()) == torch.nonzero(
                frontier.any(dim=1))[:, 0].tolist()
            assert not hit.any()
            if t > 0:
                assert not (frontier & active).any()
            cnt = self.deg[queue]
            offs = torch.cumsum(cnt, 0) - cnt
            D = int(cnt.sum())
            self.pairs.append(D)
            if D > self.limit:
                self.modes.append("dense")
                u, v, slot = self.triples
            else:
                self.modes.append("push")
                g = torch.arange(D)
                q = torch.searchsorted(offs, g, right=True) - 1
                u = queue[q]
                k = self.ptr[u] + g - offs[q]
                # the pair lies in its vertex's own row
                assert ((k >= self.ptr[u]) & (k < self.ptr[u + 1])).all()
                v, slot = self.recv[k], self.slot[k]
            # the receivers' active columns: active and the frontier
            self._fire(t, u, v, slot, frontier, active | frontier, hit)
            touched = torch.nonzero(hit.any(dim=1))[:, 0]
            assert (stamp[touched] < t).all()
            stamp[touched] = t
            lists[cur] = self._shuffled(touched)
            # the same pass: fold Q_t's frontier into active, clear
            # hit_{t - 2} over T_{t - 2}
            active[queue] |= frontier[queue]
            if lists[old] is not None:
                hits[old][lists[old]] = False
            assert not hits[old].any()
            t += 1
        last = (t + 2) % 3  # the last step's hits
        if lists[last] is not None:
            active[lists[last]] |= hits[last][lists[last]]
        return icc.pack_columns(active), t


def _case(form, edges, n, mask, p, runs, limit, max_iters=200, seed=0):
    """(model, its (active, counts, steps), the plain version's, and the
    plain version's stats)."""
    B = mask.shape[1]
    W = -(-B // 32)
    words = icc.pack_columns(torch.as_tensor(mask))
    key = torch.as_tensor(np.asarray(KEY, np.int64))
    thr = icc.coin_threshold(p)
    stats = {}
    if form == "gather":
        plan = tic.build_cascade_plan(edges, n, "cpu")
        args = (plan["table"], plan["ov_ptr"], plan["ov_src"])
        # the push lists; the model's dense pass walks the triples
        lists = icc.table_push_lists(plan["table"], plan["ov_src"],
                                     plan["ov_dst"], plan["ov_ptr"])[:3]
        u, v, slot = icc.table_triples(*args)
        want = icc.ic_cascade_reference(*args, words, key, thr, max_iters, B,
                                        runs, stats=stats)
    else:
        src, dst = tic.directed_edges(edges, "cpu")
        lists = ics.edge_push_lists(src, dst, n)
        u, v, slot = src.long(), dst.long(), torch.arange(src.shape[0])
        want = ics.ic_scatter_reference(src, dst, words, key, thr, max_iters,
                                        B, runs, stats=stats)
    model = _Model(lists, (u, v, slot), n, W, KEY, thr,
                   icc.check_runs(B, runs), limit, seed)
    active, steps = model.run(words, max_iters)
    counts = icc.unpack_columns(active, B).sum(dim=0, dtype=torch.int32)
    return model, (active, counts, steps), want, stats


def _seed_mask(n, B, per_col=2, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, B), bool)
    for b in range(B):
        mask[rng.choice(n, per_col, replace=False), b] = True
    mask[n - 1, ::3] = True  # an isolated vertex: a queue entry of no pairs
    return mask


def _assert_model_equals_plain(got, want, stats, model):
    active, counts, steps = got
    assert torch.equal(active, want[0])
    assert torch.equal(counts, want[1])
    assert steps == int(want[2])
    assert model.pairs == stats["step_pairs"]


# (B, runs): W = 1, 2 and 64 words; every column its own coins, runs 3, 4
# and 32 (column b draws as run b mod runs)
LAYOUTS = [(24, None), (30, 3), (64, 4), (40, None), (2048, 32)]


@pytest.mark.fast
@pytest.mark.parametrize("form", ["gather", "scatter"])
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("B,runs", LAYOUTS)
def test_model_equals_plain(form, p, B, runs):
    """Push only, dense only, and a limit between: the same active words,
    counts and steps as the plain version, bit for bit."""
    edges, n = _graph(seed=int(B) + int(10 * p))
    mask = _seed_mask(n, B, per_col=1 if B > 64 else 2, seed=B)
    limits = (1 << 62, -1, 40)
    if B > 64:  # the wide layout: one switching schedule
        limits = (40,)
    for i, limit in enumerate(limits):
        model, got, want, stats = _case(form, edges, n, mask, p, runs, limit,
                                        seed=i)
        _assert_model_equals_plain(got, want, stats, model)
        if limit < 0:
            assert set(model.modes) == {"dense"}
        if limit > 1 << 61:
            assert set(model.modes) == {"push"}


@pytest.mark.fast
@pytest.mark.parametrize("form", ["gather", "scatter"])
def test_push_dense_push(form):
    """At p=0.5 from one seed a column's frontier grows and then shrinks:
    with the limit at half the largest queue's pairs, the steps go push,
    then dense, then push again, and the result does not move."""
    edges, n = _graph(seed=7)
    mask = np.zeros((n, 40), bool)
    mask[10] = True
    _, _, _, stats = _case(form, edges, n, mask, 0.5, None, 1 << 62)
    limit = max(stats["step_pairs"]) // 2
    model, got, want, stats = _case(form, edges, n, mask, 0.5, None, limit)
    _assert_model_equals_plain(got, want, stats, model)
    modes = "".join(m[0] for m in model.modes)
    assert "pd" in modes and "dp" in modes, modes
    for max_iters in (0, 1, 3):  # a cut cascade stops where the plain does
        model, got, want, stats = _case(form, edges, n, mask, 0.5, None,
                                        limit, max_iters=max_iters)
        _assert_model_equals_plain(got, want, stats, model)


@pytest.mark.fast
@pytest.mark.parametrize("form", ["gather", "scatter"])
def test_greedy_base_group_layout(form):
    """A greedy chunk as greedy builds it (``_chunk_words``: 63 candidates
    x 32 runs, then 32 base-only runs; B = 2048, run r of every group on
    the same coins), over a base of two seeds."""
    edges, n = _graph(seed=11)
    base = torch.zeros(n, dtype=torch.bool)
    base[[3, 60]] = True
    words, B = tinf._chunk_words(base, torch.arange(20, 83), 32, 32)
    mask = icc.unpack_columns(words, B).numpy()
    model, got, want, stats = _case(form, edges, n, mask, 0.2, 32, 30)
    _assert_model_equals_plain(got, want, stats, model)
    assert B == 2048 and {"push", "dense"} <= set(model.modes)


@pytest.mark.fast
def test_table_dense_limit():
    """The gather form's limit: DENSE_BETA x G x its slots, but every step
    dense in auto where the table has no overflow row and its walk is one
    round of the grid; the forced modes as forced."""
    small = icc.SMALL_TABLE_ITEMS // 64
    assert icc.table_dense_limit("auto", small, 8, 0, 64) == -1
    assert icc.table_dense_limit("auto", small + 1, 8, 0, 64) == \
        icc.dense_limit("auto", (small + 1) * 8, icc.DENSE_BETA, 64) > 0
    assert icc.table_dense_limit("auto", small, 8, 3, 64) == \
        icc.dense_limit("auto", small * 8 + 3, icc.DENSE_BETA, 64) > 0
    assert icc.table_dense_limit("push", small, 8, 0, 64) > 1 << 61
    assert icc.table_dense_limit("dense", 10 * small, 8, 3, 2) == -1


@pytest.mark.fast
def test_wrappers_refuse_bad_modes_and_missing_lists():
    edges, n = _graph()
    plan = tic.build_cascade_plan(edges, n, "cpu")
    words = icc.pack_columns(torch.as_tensor(_seed_mask(n, 40)))
    key = torch.as_tensor(np.asarray(KEY, np.int64))
    gather = (plan["table"], plan["ov_ptr"], plan["ov_src"], words, key, 100,
              10, 40)
    src, dst = tic.directed_edges(edges, "cpu")
    scatter = (src, dst, words, key, 100, 10, 40)
    lists = ics.edge_push_lists(src, dst, n)
    for mode in ("auto", "push", "dense"):  # the plain version's result
        assert torch.equal(icc.ic_cascade(*gather, mode=mode)[1],
                           icc.ic_cascade(*gather)[1])
        assert torch.equal(ics.ic_scatter(*scatter, None, lists,
                                          mode=mode)[1],
                           ics.ic_scatter(*scatter)[1])
    for bad in ("Auto", "sparse", None):
        with pytest.raises(ValueError, match="mode"):
            icc.ic_cascade(*gather, mode=bad)
        with pytest.raises(ValueError, match="mode"):
            ics.ic_scatter(*scatter, mode=bad)
    # the kernels' entries refuse a call without lists before anything else
    with pytest.raises(ValueError, match="push lists"):
        icc.ic_cascade_cuda(*gather)
    with pytest.raises(ValueError, match="push lists"):
        ics.ic_scatter_cuda(*scatter)
    with pytest.raises(ValueError, match="lists"):
        ics.ic_scatter(*scatter, None, lists[:2])
    with pytest.raises(TypeError):
        ics.ic_scatter(*scatter, None, (lists[0].long(),) + lists[1:])
    with pytest.raises(ValueError):
        icc.ic_cascade(*gather, None, (lists[0][:-1],) + lists[1:])


def _push_builds():
    return icc.push_lists.builds


@pytest.mark.fast
@pytest.mark.parametrize("scatter", [False, True])
def test_greedy_builds_its_push_lists_once(monkeypatch, scatter):
    """Greedy builds its lists once where its cascades read them (here
    made to, on the CPU), and not at all where they do not (the plain
    version on the CPU)."""
    if scatter:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    edges, n = _graph(n=60, seed=5, hubs=(20,), chords=10)

    def select():
        return tinf.greedy_seed_selection((edges, n), 2, p=0.2, num_sims=4,
                                          iterations_count=20, device="cpu")

    builds = _push_builds()
    plain = select()
    assert _push_builds() == builds
    for mod in (tic, tinf):
        monkeypatch.setattr(mod, "wants_push_lists", lambda device: True)
    assert select() == plain
    assert _push_builds() == builds + 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cascade kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "scatter"])
@pytest.mark.parametrize("B,runs", LAYOUTS)
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_kernel_modes_match_plain(cuda_device, monkeypatch, form, B, runs, p):
    """Each kernel in every mode, and in auto at its DENSE_BETA and at one
    that puts the limit at half the largest step's pairs (so that the
    modes switch inside the cascade), against its plain version, bit for
    bit; one launch a cascade; the dense steps those the plain version's
    pairs per step give."""
    edges, n = _graph(seed=int(B) + int(10 * p))
    mask = _seed_mask(n, B, per_col=1 if B > 64 else 2, seed=B)
    words = icc.pack_columns(torch.as_tensor(mask, device=cuda_device))
    key = torch.as_tensor(np.asarray(KEY, np.int64), device=cuda_device)
    thr = icc.coin_threshold(p)
    W = words.shape[1]
    if form == "gather":
        plan = tic.build_cascade_plan(edges, n, cuda_device)
        args = (plan["table"], plan["ov_ptr"], plan["ov_src"], words, key,
                thr, 200, B, runs)
        lists, fn, ref, mod = plan["push"], icc.ic_cascade, \
            icc.ic_cascade_reference, icc
        slots = plan["table"].numel() + plan["ov_src"].numel()
    else:
        src, dst = tic.directed_edges(edges, cuda_device)
        args = (src, dst, words, key, thr, 200, B, runs)
        lists, fn, ref, mod = ics.edge_push_lists(src, dst, n), \
            ics.ic_scatter, ics.ic_scatter_reference, ics
        slots = src.shape[0]
    stats = {}
    want = ref(*args, stats=stats)
    pairs = stats["step_pairs"]
    half = max(pairs) // 2 / (icc.group_lanes(W) * slots)
    for mode, beta in (("push", None), ("dense", None), ("auto", None),
                       ("auto", half)):
        if beta is not None:
            monkeypatch.setattr(mod, "DENSE_BETA", beta)
        limit = icc.table_dense_limit(mode, n, *plan["table"].shape[1:],
                                      plan["ov_src"].numel(), W) \
            if form == "gather" else icc.dense_limit(mode, slots,
                                                     mod.DENSE_BETA, W)
        stats = {}
        before = fn.launches
        got = fn(*args, lists, mode=mode, stats=stats)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mode, beta)
        assert int(stats["dense_steps"]) == sum(d > limit for d in pairs)


@pytest.mark.cuda
def test_kernel_refuses_missing_lists(cuda_device):
    edges, n = _graph()
    plan = tic.build_cascade_plan(edges, n, cuda_device)
    words = icc.pack_columns(torch.as_tensor(_seed_mask(n, 40),
                                             device=cuda_device))
    key = torch.as_tensor(np.asarray(KEY, np.int64), device=cuda_device)
    with pytest.raises(ValueError, match="push lists"):
        icc.ic_cascade(plan["table"], plan["ov_ptr"], plan["ov_src"], words,
                       key, 100, 10, 40)
    src, dst = tic.directed_edges(edges, cuda_device)
    with pytest.raises(ValueError, match="push lists"):
        ics.ic_scatter(src, dst, words, key, 100, 10, 40)
