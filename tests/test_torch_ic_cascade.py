"""The IC cascade of the PyTorch port (``ops/ic_cascade.py``): its Philox
coins, the bit packing, and its plain version against an independent numpy
cascade that draws the same coins.

The plain version is what the wrapper runs for CPU tensors. Its coins are
a fixed function of (step, vertex, slot, column) under one key, so a
cascade written here in numpy on unpacked bool state, drawing every
attempted coin with a numpy Philox, must give the same active sets and
counts, count for count. The CUDA kernel (``csrc/ic_cascade.cu``) is held
against the plain version, bit for bit, by the tests marked ``cuda``, which
need a card (the card's machine has no JAX, so run them without the
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_ic_cascade.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_cascade as icc
from graphem_rapids_torch.ops import ic_sim as tic
from graphem_rapids_torch.utils import tracing

_MASK = np.uint64(0xFFFFFFFF)


def _np_philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 in numpy uint64 (each product of two 32-bit words is
    exact below 2^64)."""
    c = [np.asarray(x, np.uint64) & _MASK for x in (c0, c1, c2, c3)]
    c = list(np.broadcast_arrays(*c))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & _MASK
            k1 = (k1 + np.uint64(0xBB67AE85)) & _MASK
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _MASK,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _MASK]
    return c


def _np_coins(t, v, j, b, key, thr):
    lanes = np.stack(_np_philox(b >> 2, j, v, t, key[0], key[1]), axis=-1)
    r = np.take_along_axis(lanes, (b & 3)[..., None].astype(np.int64),
                           axis=-1)[..., 0]
    return r < np.uint64(thr)


def _np_cascade(arrays, seed, key, thr, max_iters, runs=None):
    """Independent numpy cascade on (n, B) bool state: every slot and
    overflow in-edge whose source is in the frontier draws its coin,
    column b as run b mod ``runs`` (None: every column its own)."""
    table, ov_ptr, ov_src = arrays["table"], arrays["ov_ptr"], arrays["ov_src"]
    n, cap = table.shape
    dst = np.concatenate([np.repeat(np.arange(n), cap),
                          np.repeat(np.arange(n), np.diff(ov_ptr))])
    slot = np.concatenate([np.tile(np.arange(cap), n),
                           cap + np.arange(len(ov_src))])
    src = np.concatenate([table.reshape(-1), ov_src]).astype(np.int64)
    active, frontier, steps = seed.copy(), seed.copy(), 0
    for t in range(max_iters):
        e, b = np.nonzero(frontier[src])
        r = b if runs is None else b % runs
        fire = _np_coins(t, dst[e].astype(np.uint64), slot[e].astype(
            np.uint64), r.astype(np.uint64), key, thr)
        hit = np.zeros_like(active)
        hit[dst[e][fire], b[fire]] = True
        newly = hit & ~active
        active |= newly
        frontier = newly
        steps += 1
        if not newly.any():
            break
    return active, steps


def _edges_with_hubs(seed=0):
    """200 vertices: hubs 0 and 1 with 60 and 35 random neighbours over a
    ring, so their in-edges overflow the table."""
    rng = np.random.default_rng(seed)
    e = [(j, (j + 1) % 200) for j in range(200)]
    e += [(0, int(u)) for u in rng.choice(np.arange(2, 200), 60, False)]
    e += [(1, int(u)) for u in rng.choice(np.arange(2, 200), 35, False)]
    e = {tuple(sorted(p)) for p in e if p[0] != p[1]}
    return np.array(sorted(e), np.int64), 200


def _edges_regular(seed=0):
    """200 vertices, union of three random Hamiltonian cycles."""
    rng = np.random.default_rng(seed)
    e = set()
    for _ in range(3):
        p = rng.permutation(200)
        e |= {tuple(sorted((int(a), int(b))))
              for a, b in zip(p, np.roll(p, -1))}
    return np.array(sorted(e), np.int64), 200


def _plan(kind):
    edges, n = (_edges_with_hubs if kind == "hubs" else _edges_regular)()
    arrays = tic.cascade_plan_arrays(edges, n)
    has_overflow = len(arrays["ov_src"]) > 0
    assert has_overflow == (kind == "hubs")
    return arrays, n


def _seeds(n, B, seed=1):
    """(n, B) bool, three random seeds per column."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, B), bool)
    for b in range(B):
        mask[rng.choice(n, 3, replace=False), b] = True
    return mask


def _run(arrays, seed_mask, key, thr, max_iters, device="cpu", runs=None):
    plan = tic.upload_plan(arrays, device)
    words = icc.pack_columns(torch.as_tensor(seed_mask, device=device))
    k = torch.as_tensor(np.asarray(key, np.int64), device=device)
    lists = icc.table_push_lists(plan["table"], plan["ov_src"],
                                 plan["ov_dst"], plan["ov_ptr"])
    return icc.ic_cascade(plan["table"], plan["ov_ptr"], plan["ov_src"],
                          words, k, thr, max_iters, seed_mask.shape[1], runs,
                          lists)


@pytest.mark.fast
def test_philox_known_answer_and_numpy():
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(x) for x in icc.philox4x32_10(z, z, z, z, z, z)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2**32, (4, 5000), dtype=np.uint64)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64)
    want = _np_philox(*c, k[0], k[1])
    ct = torch.as_tensor(c.astype(np.int64))
    kt = torch.as_tensor(k.astype(np.int64))
    got = icc.philox4x32_10(*ct, kt[0], kt[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.fast
@pytest.mark.parametrize("p", [0.0, 0.1, 0.37, 1.0])
def test_coin_rate(p):
    N = 10**6
    i = torch.arange(N, dtype=torch.int64)
    key = torch.tensor([123456789, 987654321], dtype=torch.int64)
    fires = icc.coin_fires(3, i // 64, i % 7, i % 64, key,
                           icc.coin_threshold(p))
    rate = fires.double().mean().item()
    if p in (0.0, 1.0):
        assert rate == p
    else:
        assert abs(rate - p) < 5 * np.sqrt(p * (1 - p) / N), rate
    assert icc.coin_threshold(0.0) == 0
    assert icc.coin_threshold(1.0) == 2**32
    assert icc.coin_threshold(2.0) == 2**32


@pytest.mark.fast
@pytest.mark.parametrize("B", [1, 31, 32, 33, 64, 100])
def test_pack_round_trip(B):
    rng = np.random.default_rng(B)
    mask = torch.as_tensor(rng.random((17, B)) < 0.5)
    words = icc.pack_columns(mask)
    assert words.dtype == torch.int32 and words.shape == (17, -(-B // 32))
    assert torch.equal(icc.unpack_columns(words, B), mask)
    np.testing.assert_array_equal(icc.pack_columns_np(mask.numpy()),
                                  words.numpy())
    # bit b of word b // 32, nothing past B
    full = icc.column_mask_words(B, "cpu")
    assert torch.equal(icc.unpack_columns(full[None], -(-B // 32) * 32)[0],
                       torch.arange(-(-B // 32) * 32) < B)
    assert torch.equal(words & ~full, torch.zeros_like(words))


@pytest.mark.fast
@pytest.mark.parametrize("kind", ["hubs", "regular"])
@pytest.mark.parametrize("B", [1, 33, 64, 100])
@pytest.mark.parametrize("p,max_iters", [(0.3, 200), (0.6, 3), (1.0, 200)])
def test_plain_matches_numpy_cascade(kind, B, p, max_iters):
    arrays, n = _plan(kind)
    seed = _seeds(n, B)
    key = (0x12345678, 0x9ABCDEF0)
    thr = icc.coin_threshold(p)
    want, want_steps = _np_cascade(arrays, seed, key, thr, max_iters)
    active, counts, steps = _run(arrays, seed, key, thr, max_iters)
    assert torch.equal(icc.unpack_columns(active, B), torch.as_tensor(want))
    np.testing.assert_array_equal(counts.numpy(), want.sum(axis=0))
    assert int(steps) == want_steps
    assert counts.dtype == torch.int32 and counts.shape == (B,)
    if max_iters == 3:
        assert want_steps == 3
    assert (counts.numpy() >= 3).all()


@pytest.mark.fast
@pytest.mark.parametrize("B,runs", [(100, 30), (96, 32), (64, 1), (70, 7),
                                    (40, 40)])
def test_runs_share_coins(B, runs):
    """Column b draws the coins of run b mod runs: the plain version
    equals the numpy cascade that draws so, runs = B equals the default,
    and columns runs apart that hold the same seeds give the same run."""
    arrays, n = _plan("hubs")
    seed = _seeds(n, runs)[:, np.arange(B) % runs]  # groups of equal seeds
    key = (0x2468ACE0, 0x13579BDF)
    thr = icc.coin_threshold(0.3)
    want, want_steps = _np_cascade(arrays, seed, key, thr, 200, runs)
    active, counts, steps = _run(arrays, seed, key, thr, 200, runs=runs)
    assert torch.equal(icc.unpack_columns(active, B), torch.as_tensor(want))
    assert int(steps) == want_steps
    c = counts.numpy()
    np.testing.assert_array_equal(c, c[np.arange(B) % runs])
    if runs == B:
        for g, w in zip(_run(arrays, seed, key, thr, 200), (active, counts,
                                                           steps)):
            assert torch.equal(g, w)
    else:  # independent coins give the groups different runs
        free = _run(arrays, seed, key, thr, 200)[1].numpy()
        assert (free != free[np.arange(B) % runs]).any()


@pytest.mark.fast
def test_steps_after_the_frontier_empties_change_nothing():
    arrays, n = _plan("hubs")
    seed = _seeds(n, 40)
    thr = icc.coin_threshold(0.2)
    active, counts, steps = _run(arrays, seed, (5, 6), thr, 200)
    s = int(steps)
    assert 1 <= s < 200
    for more in (s, s + 1, 1000):
        a, c, st = _run(arrays, seed, (5, 6), thr, more)
        assert torch.equal(a, active) and torch.equal(c, counts)
        assert int(st) == s
    # one step fewer stops before the last activations
    a, c, st = _run(arrays, seed, (5, 6), thr, s - 1)
    assert int(st) == s - 1 and (c <= counts).all()
    # no step leaves exactly the seeds
    a, c, st = _run(arrays, seed, (5, 6), thr, 0)
    assert int(st) == 0 and (c == 3).all()
    assert torch.equal(a, icc.pack_columns(torch.as_tensor(seed)))


@pytest.mark.fast
def test_same_key_same_counts_through_ic_sim():
    edges, n = _edges_with_hubs()
    a, _ = tic.independent_cascade(edges, n, [3, 50], p=0.2, num_sims=70,
                                   key=9, device="cpu")
    gen = torch.Generator().manual_seed(9)
    b, _ = tic.independent_cascade(edges, n, [3, 50], p=0.2, num_sims=70,
                                   key=gen, device="cpu")
    np.testing.assert_array_equal(a, b)
    # the seed mask in every column equals the same mask packed per column
    plan = tic.build_cascade_plan(edges, n, "cpu")
    mask = torch.zeros(n, dtype=torch.bool)
    mask[[3, 50]] = True
    c1 = tic._ic_run_table(plan, tic.seed_words(mask, 70), 0.2,
                           torch.Generator().manual_seed(9), 70, 200)
    c2 = tic._ic_run_table(plan, icc.pack_columns(
        mask[:, None].expand(n, 70)), 0.2, torch.Generator().manual_seed(9),
        70, 200)
    assert torch.equal(c1, c2)
    np.testing.assert_array_equal(c1.numpy(), a)


def _assert_plan_equals_jax(got, edges, n):
    """The port's plan against the JAX package's ``build_cascade_plan``,
    array for array, and ``ov_ptr`` against its ``ov_dst``."""
    jic = pytest.importorskip("graphem_rapids_tpu.ops.ic_sim")
    want = jic.build_cascade_plan(np.asarray(edges, np.int32), n)
    for name in ("table", "ov_dst", "ov_src"):
        w = np.asarray(want[name])
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), w)
    ptr = got["ov_ptr"].numpy()
    assert ptr[0] == 0 and ptr[-1] == len(want["ov_dst"])
    np.testing.assert_array_equal(
        np.repeat(np.arange(n), np.diff(ptr)), np.asarray(want["ov_dst"]))


@pytest.mark.fast
def test_plan_arrays_equal_jax():
    for edges, n in (_edges_with_hubs(), _edges_regular()):
        _assert_plan_equals_jax(tic.build_cascade_plan(edges, n, "cpu"),
                                edges, n)


def _edges_shuffled(seed=2):
    """The hub graph's edges out of row-major order, a third of the pairs
    written (j, i): a row's in-edges then come from both halves of the
    directed lists, in an order only a stable sort keeps."""
    edges, n = _edges_with_hubs()
    rng = np.random.default_rng(seed)
    edges = edges[rng.permutation(len(edges))]
    flip = rng.random(len(edges)) < 1 / 3
    edges[flip] = edges[flip][:, ::-1]
    return edges, n


def _edges_isolated_tail():
    """The hub graph with 40 isolated vertices after its last."""
    edges, n = _edges_with_hubs()
    return edges.astype(np.int32), n + 40


@pytest.mark.fast
@pytest.mark.parametrize("chunk", [1 << 24, 7])
@pytest.mark.parametrize("graph", ["shuffled", "isolated_tail"])
def test_plan_arrays_equal_jax_on_more_edge_lists(monkeypatch, graph,
                                                  chunk):
    """Also with the degrees summed over sorts of 7 receivers, and the
    whole sort redone for the fill."""
    monkeypatch.setattr(tic, "PUSH_SORT_CHUNK", chunk)
    edges, n = {"shuffled": _edges_shuffled,
                "isolated_tail": _edges_isolated_tail}[graph]()
    arrays = tic.cascade_plan_arrays(edges, n)
    assert len(arrays["ov_src"]) > 0
    _assert_plan_equals_jax(arrays, edges, n)
    if graph == "isolated_tail":
        np.testing.assert_array_equal(
            arrays["table"][-40:].numpy(),
            np.repeat(np.arange(n - 40, n)[:, None], arrays["table"].shape[1],
                      axis=1))
        assert (arrays["ov_ptr"][-41:] == len(arrays["ov_dst"])).all()


@pytest.mark.fast
def test_plan_of_no_edges():
    """No edge: a table of one self slot a vertex, no overflow; a cascade
    leaves exactly the seeds."""
    n = 6
    arrays = tic.cascade_plan_arrays(np.zeros((0, 2), np.int32), n)
    assert torch.equal(arrays["table"],
                       torch.arange(n, dtype=torch.int32)[:, None])
    assert arrays["ov_src"].numel() == arrays["ov_dst"].numel() == 0
    assert torch.equal(arrays["ov_ptr"], torch.zeros(n + 1,
                                                     dtype=torch.int32))
    for a in arrays.values():
        assert a.dtype == torch.int32
    counts, _ = tic.independent_cascade(np.zeros((0, 2)), n, [1, 4], p=1.0,
                                        num_sims=8, device="cpu")
    assert (counts == 2).all()


@pytest.mark.fast
@pytest.mark.parametrize("chunk", [1 << 24, 7])
def test_plan_past_the_budget_sends_the_estimate_to_scatter(monkeypatch,
                                                            chunk):
    """A table of exactly TABLE_BUDGET_SLOTS slots is built, one slot more
    is not: the plan is None and the estimate takes the scatter form, with
    the counts of ``ic_scatter``'s plain version under the same key; the
    same where the degrees come from sorts of 7 receivers."""
    from graphem_rapids_torch.ops import ic_scatter as ics

    monkeypatch.setattr(tic, "PUSH_SORT_CHUNK", chunk)
    edges, n = _edges_with_hubs()
    slots = tic.cascade_plan_arrays(edges, n)["table"].numel()
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", slots)
    assert tic.cascade_plan_arrays(edges, n) is not None
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", slots - 1)
    assert tic.cascade_plan_arrays(edges, n) is None
    assert tic.build_cascade_plan(edges, n, "cpu") is None
    counts, _ = tic.independent_cascade(edges, n, [3, 50], p=0.3,
                                        num_sims=40, key=7, device="cpu")
    mask = torch.zeros(n, dtype=torch.bool)
    mask[[3, 50]] = True
    src, dst = tic.directed_edges(edges, "cpu")
    _, want, _ = ics.ic_scatter_reference(
        src, dst, tic.seed_words(mask, 40),
        icc.draw_key(torch.Generator().manual_seed(7)),
        icc.coin_threshold(0.3), 200, 40)
    np.testing.assert_array_equal(counts, want.numpy())
    assert (counts > 2).any()


@pytest.mark.fast
def test_wrapper_rejects_bad_inputs():
    arrays, n = _plan("hubs")
    plan = tic.upload_plan(arrays, "cpu")
    words = icc.pack_columns(torch.as_tensor(_seeds(n, 40)))
    key = torch.tensor([1, 2], dtype=torch.int64)
    t, ptr, src = plan["table"], plan["ov_ptr"], plan["ov_src"]
    good = (t, ptr, src, words, key, 100, 10, 40)
    icc.ic_cascade(*good)

    def bad(i, value):
        args = list(good)
        args[i] = value
        return args

    with pytest.raises(TypeError):
        icc.ic_cascade(*bad(0, t.long()))
    with pytest.raises(TypeError):
        icc.ic_cascade(*bad(3, words.bool()))
    with pytest.raises(TypeError):
        icc.ic_cascade(*bad(4, key.int()))
    with pytest.raises(ValueError, match="W"):
        icc.ic_cascade(*bad(7, 65))  # 65 columns need 3 words
    with pytest.raises(ValueError, match="W"):
        icc.ic_cascade(*bad(3, words[:, :1].contiguous()))
    with pytest.raises(ValueError):
        icc.ic_cascade(*bad(0, t.reshape(-1)))
    with pytest.raises(ValueError):
        icc.ic_cascade(*bad(1, ptr[:-1]))
    with pytest.raises(ValueError):
        icc.ic_cascade(*bad(4, key[:1]))
    with pytest.raises(ValueError):
        icc.ic_cascade(*bad(5, 2**32 + 1))
    with pytest.raises(ValueError):
        icc.ic_cascade(*bad(3, words.t().contiguous().t()))
    with pytest.raises(ValueError, match="runs"):
        icc.ic_cascade(*good, 0)
    with pytest.raises(ValueError, match="runs"):
        icc.ic_cascade(*good, 41)
    with pytest.raises(ValueError):
        icc.ic_cascade_cuda(*good)  # CPU tensors never reach the kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cascade kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hubs", "regular"])
@pytest.mark.parametrize("B,runs", [(1, None), (33, None), (64, None),
                                    (2048, None), (2048, 32), (100, 30),
                                    (33, 1)])
@pytest.mark.parametrize("p,max_iters", [(0.0, 200), (0.3, 200), (0.6, 3),
                                         (1.0, 200), (0.3, 0)])
def test_kernel_matches_plain(cuda_device, kind, B, runs, p, max_iters):
    arrays, n = _plan(kind)
    seed = _seeds(n, B)
    key = (0xDEADBEEF, 0x01234567)
    thr = icc.coin_threshold(p)
    launches = icc.ic_cascade.launches
    got = _run(arrays, seed, key, thr, max_iters, device=cuda_device,
               runs=runs)
    torch.cuda.synchronize()
    assert icc.ic_cascade.launches == launches + 1
    plan = tic.upload_plan(arrays, cuda_device)
    want = icc.ic_cascade_reference(
        plan["table"], plan["ov_ptr"], plan["ov_src"],
        icc.pack_columns(torch.as_tensor(seed, device=cuda_device)),
        torch.as_tensor(np.asarray(key, np.int64), device=cuda_device),
        thr, max_iters, B, runs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _heavy_tail_adjacency(n=20_000, seed=0):
    """A ring on n vertices and 3n chords, the first end of each min(zipf
    (1.6), n) - 1 and the second uniform (the benchmark's heavy-tail family
    at 1/50 of its size), as a symmetric CSR: vertex 0 is a hub of
    thousands of edges, so the plan has an overflow."""
    rng = np.random.default_rng(seed)
    a = np.minimum(rng.zipf(1.6, 3 * n), n) - 1
    b = rng.integers(0, n, 3 * n)
    rows = np.concatenate([np.arange(n), a])
    cols = np.concatenate([(np.arange(n) + 1) % n, b])
    keep = rows != cols
    adj = sp.coo_matrix((np.ones(keep.sum()), (rows[keep], cols[keep])),
                        shape=(n, n)).tocsr()
    adj = (adj + adj.T).tocsr()
    adj.data[:] = 1
    return adj


@pytest.mark.cuda
def test_card_plan_equals_cpu_plan(cuda_device):
    """Built on the card from the numpy edges, from int64 edges, or from
    edges already there, the plan is the CPU's bit for bit."""
    edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    want = tic.cascade_plan_arrays(edges, n)
    assert len(want["ov_src"]) > 0
    for got in (tic.cascade_plan_arrays(edges, n, cuda_device),
                tic.cascade_plan_arrays(edges.astype(np.int64), n,
                                        cuda_device),
                tic.cascade_plan_arrays(torch.as_tensor(edges,
                                                        device=cuda_device),
                                        n)):
        for name, w in want.items():
            assert got[name].is_cuda and got[name].dtype == torch.int32
            assert torch.equal(got[name].cpu(), w), name


@pytest.mark.cuda
def test_card_estimate_equals_cpu(cuda_device, monkeypatch):
    """One coin key gives the same counts on the card and on the CPU. The
    key is fixed here: an int key seeds a generator on each device, and the
    two devices' generators draw different keys from one seed."""
    monkeypatch.setattr(tic, "draw_key", lambda gen: torch.tensor(
        [0x2545F491, 0x4F6CDD1D], dtype=torch.int64, device=gen.device))
    adj = _heavy_tail_adjacency()
    seeds = np.random.default_rng(1).choice(adj.shape[0], 10, replace=False)
    kw = dict(p=0.1, num_sims=64, key=2**40 + 7)
    edges, n = tinf._as_edges_and_n(adj)
    card, _ = tic.independent_cascade(edges, n, seeds, device=cuda_device,
                                      **kw)
    cpu, _ = tic.independent_cascade(edges, n, seeds, device="cpu", **kw)
    np.testing.assert_array_equal(card, cpu)
    assert cpu.mean() > 20  # the cascades spread past their seeds
    assert tinf.estimated_influence(adj, seeds, device=cuda_device, **kw) \
        == tinf.estimated_influence(adj, seeds, device="cpu", **kw)


@pytest.mark.cuda
def test_card_plan_holds_only_its_own_bytes(cuda_device):
    """Nothing of the build outlives it but the plan: the device memory
    after it exceeds that before by the plan's own bytes (requested, and
    as the caching allocator rounds them: 512 bytes in its small pool),
    and falls back once the plan is let go."""
    edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    tic.cascade_plan_arrays(edges, n, cuda_device)  # the first calls' set-up
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    arrays = tic.cascade_plan_arrays(edges, n, cuda_device)
    torch.cuda.synchronize()
    sizes = [a.numel() * a.element_size() for a in arrays.values()]
    assert [a.untyped_storage().nbytes() for a in arrays.values()] == sizes
    assert max(sizes) <= 1 << 20  # the small pool's
    assert torch.cuda.memory_stats()["requested_bytes.all.current"] \
        - requested == sum(sizes)
    assert torch.cuda.memory_allocated() - alloc == sum(
        -(-b // 512) * 512 for b in sizes)
    del arrays
    assert torch.cuda.memory_allocated() == alloc


@pytest.mark.cuda
def test_card_plan_past_the_budget_leaves_nothing(cuda_device, monkeypatch):
    """Past the budget the decision on the card frees all it built, counts
    no plan, and the estimate's scatter form gives the CPU's counts."""
    monkeypatch.setattr(tic, "draw_key", lambda gen: torch.tensor(
        [0x2545F491, 0x4F6CDD1D], dtype=torch.int64, device=gen.device))
    adj = _heavy_tail_adjacency()
    edges, n = tinf._as_edges_and_n(adj)
    slots = tic.cascade_plan_arrays(edges, n, cuda_device)["table"].numel()
    monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", slots - 1)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    built = tracing.snapshot()["counters"].get("ic.plan.card", 0)
    assert tic.cascade_plan_arrays(edges, n, cuda_device) is None
    assert torch.cuda.memory_allocated() == alloc
    assert tracing.snapshot()["counters"].get("ic.plan.card", 0) == built
    seeds = np.random.default_rng(1).choice(n, 10, replace=False)
    kw = dict(p=0.1, num_sims=64, key=5)
    card, _ = tic.independent_cascade(edges, n, seeds, device=cuda_device,
                                      **kw)
    cpu, _ = tic.independent_cascade(edges, n, seeds, device="cpu", **kw)
    np.testing.assert_array_equal(card, cpu)
    assert cpu.mean() > 20


@pytest.mark.cuda
def test_card_plan_counter_counts_each_estimate(cuda_device):
    """``ic.plan.card`` counts one plan an estimate on the card, none on
    the CPU."""
    adj = _heavy_tail_adjacency()

    def built():
        return tracing.snapshot()["counters"].get("ic.plan.card", 0)

    before = built()
    for key in range(3):
        tinf.estimated_influence(adj, [1, 2, 3], num_sims=32, key=key,
                                 device=cuda_device)
    assert built() == before + 3
    tinf.estimated_influence(adj, [1, 2, 3], num_sims=32, key=0,
                             device="cpu")
    assert built() == before + 3
