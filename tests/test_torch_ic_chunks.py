"""The gather cascade's chunk list (``ops/ic_cascade.py``
``overflow_chunks``, the fourth of ``table_push_lists``' kernel lists) and
the dense pass that walks it.

The dense pass of ``csrc/ic_cascade.cu`` hands out two kinds of work item
over the whole grid: (chunk, word) items, a warp each, for the overflow
rows of at least LONG_ROW in-edges, cut into chunks of CHUNK_EDGES
in-edges; and (vertex, word) items, a lane each, which walk the table row
and the overflow row where it is shorter than LONG_ROW. So each in-edge of
a long row must lie in exactly one chunk, and every slot of the plan in
exactly one item's walk. The CPU tests hold the list to that, on fabricated
row starts and on the plans of the repo's test graphs, the plan's count of
it (from its host degrees) to its length, and the counter
``ic.dense_chunks`` to its arithmetic. The kernel itself is held against
the plain version on a graph whose 16 first vertices are zipf hubs, all in
one warp's items, by the tests marked ``cuda`` (run without the conftest
on the card's machine, which has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_ic_chunks.py
"""

import numpy as np
import pytest
import torch

from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_cascade as icc
from graphem_rapids_torch.ops import ic_sim as tic
from graphem_rapids_torch.utils import tracing

from test_torch_ic_cascade import (_edges_regular, _edges_with_hubs,
                                   _heavy_tail_adjacency)

K = icc.CHUNK_EDGES
LONG = icc.LONG_ROW
KEY = (0x2545F491, 0x6C078965)


def _ptr(lengths):
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]),
                           dtype=torch.int32)


def _assert_covers(chunks, ov_ptr):
    """Each in-edge of a row of at least LONG in-edges lies in exactly one
    chunk, the chunks of a row in order from its first in-edge, each K
    long but the row's last (1 to K); no chunk in a shorter row."""
    assert chunks.dtype == torch.int32 and chunks.ndim == 2 \
        and chunks.shape[1] == 2 and chunks.is_contiguous()
    ptr = ov_ptr.long().numpy()
    rows, first = chunks.long().numpy().T
    want_rows, want_first = [], []
    for v in range(len(ptr) - 1):
        a, b = ptr[v], ptr[v + 1]
        if b - a >= LONG:
            starts = list(range(a, b, K))
            want_rows += [v] * len(starts)
            want_first += starts
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(first, want_first)
    ends = np.minimum(first + K, ptr[rows + 1])
    covered = np.zeros(ptr[-1], np.int64)
    for a, b in zip(first, ends):
        covered[a:b] += 1
    long_row = np.repeat(np.diff(ptr) >= LONG, np.diff(ptr))
    np.testing.assert_array_equal(covered, long_row.astype(np.int64))
    return ends - first


def _plan_arrays(graph, stats=None):
    if graph == "hubs":
        edges, n = _edges_with_hubs()
    elif graph == "regular":
        edges, n = _edges_regular()
    elif graph == "zipf_hubs":
        edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    else:
        edges, n = _uniform_chords()
    return tic.cascade_plan_arrays(edges, n, stats=stats)


def _uniform_chords(n=20_000, seed=0):
    """A ring on n vertices and 3n uniform chords (the benchmark's uniform
    family at 1/50 of its 1M size): (E, 2) int64 edges, and n."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    b = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 3 * n)])
    keep = a != b
    e = np.unique(np.sort(np.stack([a[keep], b[keep]], 1), axis=1), axis=0)
    return e.astype(np.int64), n


@pytest.mark.fast
@pytest.mark.parametrize("lengths", [
    [], [0], [LONG - 1], [LONG], [LONG + 1], [K - 1], [K], [K + 1],
    [8 * K + 331, 0, LONG - 1, LONG, K, 2 * K, 3, LONG + 1],
    [0, 0, 9 * K, 1, 1, 5 * K - 1],
])
def test_chunks_of_fabricated_rows(lengths):
    """Rows around LONG and around a multiple of K: the last chunk partial
    (or whole where K divides the row), shorter rows in none."""
    ptr = _ptr(lengths)
    sizes = _assert_covers(icc.overflow_chunks(ptr), ptr)
    assert ((sizes >= 1) & (sizes <= K)).all()
    want = sum(-(-x // K) for x in lengths if x >= LONG)
    assert len(sizes) == want


@pytest.mark.fast
@pytest.mark.parametrize("graph,want", [
    ("hubs", [58, 33]), ("zipf_hubs", None), ("regular", []),
    ("uniform", []),
])
def test_chunks_of_the_test_graphs(graph, want):
    """The plans of the tests' graphs: the two hubs of ``_edges_with_hubs``
    a chunk each; the zipf hub graph 121 chunks, its largest row (vertex
    0) 14 whole chunks and a partial one, and rows just under, at and
    just over LONG; no overflow row of LONG in-edges in the uniform graphs
    (the 20,000-vertex ring and chords has an overflow, of short rows)."""
    arrays = _plan_arrays(graph)
    ptr = arrays["ov_ptr"]
    chunks = icc.overflow_chunks(ptr)
    sizes = _assert_covers(chunks, ptr)
    lengths = (ptr[1:] - ptr[:-1]).numpy()
    if want is not None:
        assert sizes.tolist() == want
    if graph == "zipf_hubs":
        assert len(chunks) == 121
        # vertices 0-15 hold the 16 longest rows
        assert np.sort(lengths)[-16:].tolist() == sorted(lengths[:16])
        assert lengths[0] == 14 * K + 331
        assert (chunks[:, 0] == 0).sum() == 15
        for x in (LONG - 1, LONG, LONG + 1):
            assert (lengths == x).any()
    if graph == "uniform":
        assert 0 < len(arrays["ov_src"]) and lengths.max() < LONG
        assert chunks.shape == (0, 2)


@pytest.mark.fast
@pytest.mark.parametrize("graph", ["hubs", "zipf_hubs", "regular", "uniform"])
def test_dense_items_walk_every_slot_once(graph):
    """The dense pass's items as the kernel forms them: the chunk items
    walk [o0, min(o0 + K, row end)); a (vertex, word) item walks its table
    row, and its overflow row where that is shorter than LONG. Every slot
    of the plan (n * cap table slots, O overflow in-edges) lies in exactly
    one walk, so the pass ORs the coins of every slot into its receiver's
    word once, whatever the order."""
    arrays = _plan_arrays(graph)
    table, ptr = arrays["table"], arrays["ov_ptr"].long().numpy()
    n, cap = table.shape
    walked = np.zeros(n * cap + ptr[-1], np.int64)
    chunks = icc.overflow_chunks(arrays["ov_ptr"]).long().numpy()
    for v, o0 in chunks:
        walked[n * cap + o0:n * cap + min(o0 + K, ptr[v + 1])] += 1
    walked[:n * cap] += 1  # the owners' table rows
    for v in range(n):
        if ptr[v + 1] - ptr[v] < LONG:
            walked[n * cap + ptr[v]:n * cap + ptr[v + 1]] += 1
    assert (walked == 1).all()


@pytest.mark.fast
@pytest.mark.parametrize("graph,want", [
    ("hubs", 2), ("zipf_hubs", 121), ("regular", 0), ("uniform", 0),
])
def test_plan_counts_its_chunks(graph, want):
    """The plan counts its chunk list from the degrees it reads for its
    cap, with no read of the device: the count is the list's length, which
    ``table_push_lists`` then builds without a read of its own."""
    stats = {}
    arrays = _plan_arrays(graph, stats)
    assert stats["chunks"] == want == len(icc.overflow_chunks(
        arrays["ov_ptr"]))
    lists = icc.table_push_lists(arrays["table"], arrays["ov_src"],
                                 arrays["ov_dst"], arrays["ov_ptr"], want)
    assert torch.equal(lists[3], icc.overflow_chunks(arrays["ov_ptr"]))
    stats = {}
    tic.cascade_plan_arrays(np.zeros((0, 2), np.int32), 5, stats=stats)
    assert stats["chunks"] == 0


@pytest.mark.fast
def test_plan_carries_its_chunks(monkeypatch):
    """A plan for a card carries its chunk list as its kernel lists'
    fourth member, the list of its own row starts; a CPU plan carries no
    lists."""
    edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    assert "push" not in tic.build_cascade_plan(edges, n, "cpu")
    monkeypatch.setattr(tic, "wants_push_lists", lambda device: True)
    plan = tic.build_cascade_plan(edges, n, "cpu")
    assert len(plan["push"]) == 4 and "chunks" not in plan
    assert torch.equal(plan["push"][3], icc.overflow_chunks(plan["ov_ptr"]))
    assert plan["push"][3].shape == (121, 2)


@pytest.mark.fast
def test_wrapper_checks_the_chunks():
    """The plain version takes the plan's four lists and ignores them; a
    chunk list of another type, shape or length past O // LONG_ROW is
    refused, and so are the push lists without their chunk list."""
    arrays = _plan_arrays("hubs")
    n = arrays["table"].shape[0]
    words = icc.pack_columns(torch.zeros((n, 40), dtype=torch.bool))
    key = torch.tensor(KEY, dtype=torch.int64)
    args = (arrays["table"], arrays["ov_ptr"], arrays["ov_src"], words, key,
            100, 10, 40, None)
    lists = icc.table_push_lists(arrays["table"], arrays["ov_src"],
                                 arrays["ov_dst"], arrays["ov_ptr"])
    push, chunks = lists[:3], lists[3]
    for got, want in zip(icc.ic_cascade(*args, lists),
                         icc.ic_cascade(*args)):
        assert torch.equal(got, want)
    with pytest.raises(TypeError, match="chunks"):
        icc.ic_cascade(*args, push + (chunks.long(),))
    with pytest.raises(ValueError, match="chunks"):
        icc.ic_cascade(*args, push + (chunks.reshape(-1),))
    with pytest.raises(ValueError, match="chunks"):
        icc.ic_cascade(*args, push + (chunks.t(),))
    too_many = len(arrays["ov_src"]) // LONG + 1
    with pytest.raises(ValueError, match="chunks"):
        icc.ic_cascade(*args, push + (chunks[:1].repeat(too_many, 1),))
    with pytest.raises(ValueError, match="chunks"):
        icc.ic_cascade(*args, push)


def _counters():
    return tracing.snapshot()["counters"]


@pytest.mark.fast
@pytest.mark.parametrize("dense,chunk_items", [(0, 242), (6, 242), (6, 0),
                                               (13, 7744), (3, None)])
def test_dense_chunks_counter(dense, chunk_items):
    """``ic.dense_chunks`` adds the dense steps times the launch's chunk
    items, from the one copy of the outcome row; none without a chunk
    count (the scatter form) and none on the CPU."""
    row = torch.tensor([13, dense, 5, 7, 9], dtype=torch.int32)
    stats = {"outcome": row}
    if chunk_items is not None:
        stats["chunk_items"] = chunk_items
    before = _counters()
    counts, steps = tic._read_outcome(None, stats)
    after = _counters()
    assert steps == 13 and counts.tolist() == [5, 7, 9]
    assert after["ic.dense_chunks"] - before.get("ic.dense_chunks", 0) == \
        dense * (chunk_items or 0)
    assert after["ic.dense_steps"] - before.get("ic.dense_steps", 0) == dense
    before = _counters()
    tic._read_outcome(torch.tensor([4, 4]), {"steps": 3})
    assert _counters()["ic.dense_chunks"] == before["ic.dense_chunks"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cascade kernel has no CPU mode")
    return torch.device("cuda")


def _seed_mask(n, B, per_col, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((n, B), bool)
    for b in range(B):
        mask[rng.choice(n, per_col, replace=False), b] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "dense", "push"])
@pytest.mark.parametrize("B,runs", [(32, None), (64, None), (64, 30),
                                    (2048, 32)])
@pytest.mark.parametrize("p", [0.1, 0.3, 1.0])
def test_kernel_with_chunks_matches_plain(cuda_device, mode, B, runs, p):
    """The zipf hub graph (vertices 0-15 the hubs, every one in warp 0's
    items at W <= 2; the largest row 14 chunks and a partial one; rows of
    LONG - 1, LONG and LONG + 1 in-edges) at W = 1, 2 and 64, runs < B
    among them, in every mode: active words, counts and steps equal to the
    plain version's, the dense steps those its pairs per step give, one
    launch, and the launch's chunk items 121 W."""
    edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    plan = tic.build_cascade_plan(edges, n, cuda_device)
    assert plan["push"][3].shape == (121, 2)
    mask = _seed_mask(n, B, 1 if B > 64 else 3, seed=B + int(10 * p))
    words = icc.pack_columns(torch.as_tensor(mask, device=cuda_device))
    key = torch.as_tensor(np.asarray(KEY, np.int64), device=cuda_device)
    thr = icc.coin_threshold(p)
    W = words.shape[1]
    args = (plan["table"], plan["ov_ptr"], plan["ov_src"], words, key, thr,
            200, B, runs)
    ref_stats = {}
    want = icc.ic_cascade_reference(*args, stats=ref_stats)
    limit = icc.table_dense_limit(mode, n, plan["table"].shape[1],
                                  plan["ov_src"].numel(), W)
    stats = {}
    before = icc.ic_cascade.launches
    got = icc.ic_cascade(*args, plan["push"], mode=mode, stats=stats)
    torch.cuda.synchronize()
    assert icc.ic_cascade.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w), mode
    dense = sum(d > limit for d in ref_stats["step_pairs"])
    assert int(stats["dense_steps"]) == dense
    assert stats["chunk_items"] == 121 * W
    if mode == "dense":
        assert dense == int(got[2]) > 0


@pytest.mark.cuda
def test_kernel_refuses_a_call_without_chunks(cuda_device):
    """A cascade on the card needs the plan's chunk list with its push
    lists: without it the wrapper raises before any launch."""
    edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    plan = tic.build_cascade_plan(edges, n, cuda_device)
    words = icc.pack_columns(torch.as_tensor(_seed_mask(n, 64, 3, 1),
                                             device=cuda_device))
    key = torch.as_tensor(np.asarray(KEY, np.int64), device=cuda_device)
    before = icc.ic_cascade.launches
    with pytest.raises(ValueError, match="chunks"):
        icc.ic_cascade(plan["table"], plan["ov_ptr"], plan["ov_src"], words,
                       key, icc.coin_threshold(0.1), 200, 64, None,
                       plan["push"][:3])
    assert icc.ic_cascade.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("graph,chunks", [("zipf_hubs", 121),
                                          ("uniform", 0)])
def test_dense_chunks_counter_on_card(cuda_device, monkeypatch, graph,
                                     chunks):
    """An estimate on the card counts ``ic.dense_chunks`` as its dense
    steps times its plan's chunks times W (2): 0 on the uniform plan, whose
    rows are all short. One coin key on both devices: the counts equal the
    CPU's, and the dense steps those the plain version's pairs give."""
    monkeypatch.setattr(tic, "draw_key", lambda gen: torch.tensor(
        KEY, dtype=torch.int64, device=gen.device))
    if graph == "zipf_hubs":
        edges, n = tinf._as_edges_and_n(_heavy_tail_adjacency())
    else:
        edges, n = _uniform_chords()
    seeds = np.random.default_rng(1).choice(n, 10, replace=False)
    kw = dict(p=0.1, num_sims=64, key=3)
    before = _counters()
    card, _ = tic.independent_cascade(edges, n, seeds, device=cuda_device,
                                      **kw)
    after = _counters()
    dense = after["ic.dense_steps"] - before.get("ic.dense_steps", 0)
    got = after["ic.dense_chunks"] - before.get("ic.dense_chunks", 0)
    assert got == dense * chunks * 2
    cpu, _ = tic.independent_cascade(edges, n, seeds, device="cpu", **kw)
    np.testing.assert_array_equal(card, cpu)
    arrays = tic.cascade_plan_arrays(edges, n)
    stats = {}
    icc.ic_cascade_reference(
        arrays["table"], arrays["ov_ptr"], arrays["ov_src"],
        tic.seed_words(torch.as_tensor(np.isin(np.arange(n), seeds)), 64),
        torch.tensor(KEY, dtype=torch.int64), icc.coin_threshold(0.1), 200,
        64, stats=stats)
    limit = icc.table_dense_limit("auto", n, arrays["table"].shape[1],
                                  len(arrays["ov_src"]), 2)
    assert dense == sum(d > limit for d in stats["step_pairs"])
    if graph == "zipf_hubs":
        assert got > 0
