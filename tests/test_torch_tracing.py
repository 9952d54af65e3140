"""The program's spans and counters (``graphem_rapids_torch/utils/tracing.py``)
and where the program records them.

The module: nesting, parents and call ids, self time, counters, ``reset``,
the ring's bound, the kernel wrappers' ``launches`` read into the snapshot,
and each span a ``torch.profiler`` range of its name while a profiler
records. The placement, on the CPU: an engine's set-up stages, its layout
call, the positions' read split into wait, copy and permutation, the
step's stages; an estimate's stages; the compile span. The cascade's work
counters ``ic.sources`` and ``ic.pushed``, worked out from its outcome
(``frontier_work``), equal the plain version's stats, and run only while
a profiler records.
"""

import json
import logging
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from graphem_rapids_torch import _build
from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.models.embedder import GraphEmbedderTorch
from graphem_rapids_torch.ops import ic_cascade as icc
from graphem_rapids_torch.ops import ic_scatter as ics
from graphem_rapids_torch.ops import ic_sim as tic
from graphem_rapids_torch.ops import knn_binfold as bf
from graphem_rapids_torch.parallel import ring_binfold  # noqa: F401
from graphem_rapids_torch.utils import profiling as tprof
from graphem_rapids_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def one_thread():
    """The plain cascade is many small ops: on one thread its time does not
    grow with the other processes that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _by_name(recent):
    out = {}
    for r in recent:
        out.setdefault(r["name"], []).append(r)
    return out


def _one(recent, name):
    got = _by_name(recent)[name]
    assert len(got) == 1, (name, len(got))
    return got[0]


def _parent_name(recent, rec):
    ids = {r["id"]: r for r in recent}
    return ids[rec["parent"]]["name"] if rec["parent"] is not None else None


# --------------------------------------------------------------------- #
# the module
# --------------------------------------------------------------------- #

@pytest.mark.fast
def test_nesting_parents_and_call_ids():
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    recent = tracing.snapshot()["recent"]
    assert [r["name"] for r in recent] == ["c", "b", "d", "a", "e"]
    assert _parent_name(recent, _one(recent, "c")) == "b"
    assert _parent_name(recent, _one(recent, "b")) == "a"
    assert _parent_name(recent, _one(recent, "d")) == "a"
    assert _one(recent, "a")["parent"] is None
    calls = {r["name"]: r["call"] for r in recent}
    assert calls["a"] == calls["b"] == calls["c"] == calls["d"]
    assert calls["e"] != calls["a"]
    for r in recent:
        assert r["end_ns"] >= r["start_ns"]
    a, c = _one(recent, "a"), _one(recent, "c")
    assert a["start_ns"] <= c["start_ns"] <= c["end_ns"] <= a["end_ns"]


@pytest.mark.fast
def test_self_time_is_the_span_less_its_children():
    with tracing.span("outer") as outer:
        time.sleep(0.002)
        with tracing.span("inner"):
            time.sleep(0.004)
        with tracing.span("inner"):
            time.sleep(0.001)
    spans = tracing.snapshot()["spans"]
    o, i = spans["outer"], spans["inner"]
    assert o["count"] == 1 and i["count"] == 2
    assert o["total_ns"] == outer.end - outer.start
    assert outer.seconds == pytest.approx(o["total_ns"] / 1e9)
    assert o["self_ns"] == o["total_ns"] - i["total_ns"]
    assert i["self_ns"] == i["total_ns"]
    assert o["self_ns"] >= 2_000_000 and i["total_ns"] >= 5_000_000


@pytest.mark.fast
def test_counters_reset_and_the_ring_bound(monkeypatch):
    tracing.count("x")
    tracing.count("x", 5)
    tracing.count("y", 0)
    c = tracing.snapshot()["counters"]
    assert c["x"] == 6 and c["y"] == 0
    monkeypatch.setattr(tracing, "RING", 10)
    tracing.reset()
    snap = tracing.snapshot()
    assert "x" not in snap["counters"] and snap["spans"] == {}
    assert snap["recent"] == []
    for k in range(25):
        with tracing.span(f"s{k % 2}"):
            pass
    snap = tracing.snapshot()
    assert len(snap["recent"]) == 10
    assert [r["id"] for r in snap["recent"]] == list(range(16, 26))
    assert snap["spans"]["s0"]["count"] == 13
    assert snap["spans"]["s1"]["count"] == 12


@pytest.mark.fast
def test_snapshot_reads_the_wrappers_launches(monkeypatch):
    monkeypatch.setattr(bf.knn_binfold, "launches",
                        bf.knn_binfold.launches + 3)
    monkeypatch.setattr(icc.ic_cascade, "launches", 7)
    monkeypatch.setattr(icc.push_lists, "builds", 2)
    c = tracing.snapshot()["counters"]
    assert c["launches.knn_binfold"] == bf.knn_binfold.launches
    assert c["launches.ic_cascade"] == 7
    assert c["launches.push_lists"] == 2
    assert {"launches.knn_pallas", "launches.segment_sum",
            "launches.segment_sum_cluster", "launches.sort_tiles",
            "launches.ic_scatter", "launches.ring_fold"} <= set(c)
    # a reset leaves the wrappers' own counters alone
    tracing.reset()
    assert tracing.snapshot()["counters"]["launches.ic_cascade"] == 7
    # a wrapper registers itself where it is defined
    def new_kernel():
        pass
    new_kernel.calls = 5
    monkeypatch.setitem(tracing._WRAPPERS, "new_kernel", (new_kernel, "calls"))
    assert tracing.counts_launches(new_kernel, "calls") is new_kernel
    assert tracing.snapshot()["counters"]["launches.new_kernel"] == 5


def _cpu_events(prof, names):
    return [ev for ev in prof.events()
            if ev.name in names and ev.device_type == DeviceType.CPU]


@pytest.mark.fast
def test_spans_are_profiler_ranges_of_their_names():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("pt.outer"):
            time.sleep(0.02)
            with tracing.span("pt.inner"):
                time.sleep(0.02)
    recent = tracing.snapshot()["recent"]
    evs = {ev.name: ev for ev in _cpu_events(prof, ("pt.outer",
                                                    "pt.inner"))}
    assert set(evs) == {"pt.outer", "pt.inner"}
    o, i = evs["pt.outer"].time_range, evs["pt.inner"].time_range
    assert o.start <= i.start and i.end <= o.end
    for name, ev in evs.items():
        rec = _one(recent, name)
        ours_us = (rec["end_ns"] - rec["start_ns"]) / 1e3
        assert ev.time_range.elapsed_us() == pytest.approx(ours_us, rel=0.1)
    # without a profiler a span is no range, and records all the same
    with tracing.span("pt.outer"):
        pass
    assert tracing.snapshot()["spans"]["pt.outer"]["count"] == 2


@pytest.mark.fast
def test_spans_in_the_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tr"):
        with tracing.span("ct.outer"):
            with tracing.span("ct.inner"):
                torch.ones(8).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    got = {e["name"]: e for e in events
           if e.get("name") in ("ct.outer", "ct.inner")}
    assert set(got) == {"ct.outer", "ct.inner"}
    o, i = got["ct.outer"], got["ct.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


# --------------------------------------------------------------------- #
# where the program records them
# --------------------------------------------------------------------- #

def _ring_chords(n=800, chords=1600, seed=0, hubs=(300,)):
    """A ring with random chords and hubs whose degree passes the table's
    cap, as a scipy adjacency; and its (E, 2) i<j edges."""
    rng = np.random.default_rng(seed)
    e = [(j, (j + 1) % n) for j in range(n)]
    e += [tuple(p) for p in rng.integers(0, n, (chords, 2))]
    for h, size in enumerate(hubs):
        e += [(h, int(u)) for u in rng.choice(np.arange(2, n), size, False)]
    e = np.array(sorted({tuple(sorted(p)) for p in e if p[0] != p[1]}),
                 np.int64)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    return (a + a.T).tocsr(), e, n


SETUP = ("setup", "setup.edges", "setup.tables", "setup.spectral",
         "setup.upload", "spectral.plan", "spectral.iterate")
STEP = ("step.spring", "step.refs", "step.knn", "step.intersect",
        "step.update")
READ = ("layout.read.wait", "layout.read.copy", "layout.read.permute")


@pytest.mark.fast
def test_engine_records_setup_layout_and_step_stages(caplog):
    adj, _, _ = _ring_chords()
    with caplog.at_level(logging.INFO, "graphem_rapids_torch.ops.laplacian"):
        emb = GraphEmbedderTorch(adj, n_components=3, device="cpu", seed=4,
                                 init="chebyshev", knn_strategy="binfold",
                                 binned_table=True, verbose=False)
    assert "buckets" in emb._nb and emb._fused_refs_active
    snap = tracing.snapshot()
    recent, spans = snap["recent"], snap["spans"]
    for name in SETUP:
        assert spans[name]["count"] == 1, name
    for name in SETUP[1:5]:
        assert _parent_name(recent, _one(recent, name)) == "setup"
    stages = [r for r in recent
              if _parent_name(recent, r) == "setup.tables"]
    assert 3 <= len({r["name"] for r in stages}) <= 5
    assert {r["name"] for r in stages} <= {
        "tables.degrees", "tables.renumber", "tables.rows",
        "tables.overflow", "tables.refs"}
    children = sum(r["end_ns"] - r["start_ns"] for r in stages)
    assert children <= spans["setup.tables"]["total_ns"]
    assert snap["counters"]["chebyshev.matvecs"] == 8 * 15
    # the log line's seconds are the Chebyshev's two spans
    rec = [r for r in caplog.records if hasattr(r, "chebyshev_seconds")]
    assert len(rec) == 1
    want = (spans["spectral.plan"]["total_ns"]
            + spans["spectral.iterate"]["total_ns"]) / 1e9
    assert rec[0].chebyshev_seconds == pytest.approx(want)

    tracing.reset()
    pos = emb.run_layout(num_iterations=3)
    snap = tracing.snapshot()
    recent, spans = snap["recent"], snap["spans"]
    call = _one(recent, "layout.call")
    assert call["parent"] is None
    read = _one(recent, "layout.read")
    assert _parent_name(recent, read) == "layout.call"
    for name in READ:
        assert _parent_name(recent, _one(recent, name)) == "layout.read"
    for name in STEP:
        assert spans[name]["count"] == 3, name
    assert all(r["call"] == call["call"] for r in recent)
    # the CPU's loop is eager: no first step apart, no capture, no replay
    assert not {"layout.first_step", "layout.capture",
                "layout.replay"} & set(spans)
    # the read's children are the wait, the copy and the permutation, in
    # that order, and the read gives the positions in user order
    kids = [r["name"] for r in recent if r["parent"] == read["id"]]
    assert kids == list(READ)
    np.testing.assert_array_equal(
        pos, emb._positions.numpy()[emb._inv_perm])


def _four_cycles(n=100_000, seed=0):
    """bench.py's 100K graph: the union of four random Hamiltonian cycles,
    as (E, 2) i<j edges."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(4):
        p = rng.permutation(n)
        parts.append(np.column_stack([p, np.roll(p, -1)]))
    e = np.sort(np.concatenate(parts), axis=1)
    return np.unique(e, axis=0).astype(np.int64), n


def _ring_plus_chords():
    _, e, n = _ring_chords(n=3000, chords=6000, seed=2, hubs=(400, 200))
    return e, n


GRAPHS = {"100k": _four_cycles, "ring_chords": _ring_plus_chords}


def _seed_mask(n, k=10, seed=3):
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(seed).choice(n, k, replace=False)] = True
    return mask


def _plain(edges, n, mask, p, num_sims, max_iters, key, scatter,
           device="cpu"):
    """The plain version's (active, counts, steps) and stats, on the CPU,
    on the same key (drawn as ``independent_cascade`` on ``device`` draws
    it) and seed words as ``independent_cascade``'s."""
    gen = tic._generator(key, torch.device(device))
    words = tic.seed_words(torch.as_tensor(mask), num_sims)
    k = icc.draw_key(gen).cpu()
    thr = icc.coin_threshold(p)
    stats = {}
    if scatter:
        src, dst = tic.directed_edges(edges, "cpu")
        out = ics.ic_scatter_reference(src, dst, words, k, thr, max_iters,
                                       num_sims, stats=stats)
        lists = ics.edge_push_lists(src, dst, n)
    else:
        plan = tic.upload_plan(tic.cascade_plan_arrays(edges, n), "cpu")
        out = icc.ic_cascade_reference(plan["table"], plan["ov_ptr"],
                                       plan["ov_src"], words, k, thr,
                                       max_iters, num_sims, stats=stats)
        lists = icc.table_push_lists(plan["table"], plan["ov_src"],
                                     plan["ov_dst"], plan["ov_ptr"])
    return out, stats, lists


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("scatter", [False, True])
def test_work_counters_equal_the_plain_stats(monkeypatch, one_thread, graph,
                                            scatter):
    """``frontier_work`` from the outcome gives the plain version's
    'sources' and 'pushed'; through ``independent_cascade`` under a
    profiler, with push lists built on the CPU as a card's would be, the
    counters ic.sources, ic.pushed and ic.steps are the plain version's."""
    edges, n = GRAPHS[graph]()
    if scatter:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    mask = _seed_mask(n)
    p, sims, iters, key = 0.1, 32, 200, 11
    (active, counts, steps), stats, lists = _plain(
        edges, n, mask, p, sims, iters, key, scatter)
    # a cascade that stops on its own and reaches part of the graph
    assert 2 < int(steps) < iters
    assert 10 < stats["sources"] < n // 2
    assert stats["pushed"] > stats["sources"]
    got = icc.frontier_work(active, lists[0]).tolist()
    assert got == [stats["sources"], stats["pushed"]]

    monkeypatch.setattr(tic, "wants_push_lists", lambda device: True)
    seeds = np.flatnonzero(mask)
    with profile(activities=[ProfilerActivity.CPU]):
        mine, _ = tic.independent_cascade(edges, n, seeds, p=p,
                                          num_sims=sims, max_iters=iters,
                                          key=key, device="cpu")
    np.testing.assert_array_equal(mine, counts.numpy())
    snap = tracing.snapshot()
    c = snap["counters"]
    assert c["ic.cascades"] == 1 and c["ic.steps"] == int(steps)
    assert c["ic.dense_steps"] == 0
    assert c["ic.sources"] == stats["sources"]
    assert c["ic.pushed"] == stats["pushed"]
    assert snap["spans"]["ic.stats"]["count"] == 1
    assert "ic.stats_capped" not in c


@pytest.mark.fast
def test_work_counters_only_under_a_profiler_and_not_capped(monkeypatch,
                                                            one_thread):
    """Without a profiler the work is never counted (no call of
    ``frontier_work``, no ``ic.stats`` span); a cascade cut at max_iters
    counts ``ic.stats_capped`` instead; without push lists (the CPU's
    plain version) nothing is counted."""
    edges, n = _ring_plus_chords()
    seeds = np.flatnonzero(_seed_mask(n))
    calls = []
    work = icc.frontier_work

    def counted(*args):
        calls.append(1)
        return work(*args)

    monkeypatch.setattr(tic, "frontier_work", counted)

    def estimate(max_iters=200):
        return tinf.estimated_influence((edges, n), seeds, p=0.1,
                                        iterations_count=max_iters,
                                        num_sims=32, key=5, device="cpu")

    plain = estimate()
    with profile(activities=[ProfilerActivity.CPU]):
        estimate()
    assert calls == [] and "ic.stats" not in tracing.snapshot()["spans"]
    monkeypatch.setattr(tic, "wants_push_lists", lambda device: True)
    assert estimate() == plain
    assert calls == [] and "ic.stats" not in tracing.snapshot()["spans"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert estimate() == plain
        estimate(max_iters=2)
    c = tracing.snapshot()["counters"]
    assert calls == [1] and c["ic.stats_capped"] == 1
    assert tracing.snapshot()["spans"]["ic.stats"]["count"] == 1
    assert c["ic.cascades"] == 5 and c["launches.push_lists"] >= 2


@pytest.mark.fast
@pytest.mark.parametrize("scatter", [False, True])
def test_estimate_records_its_stages(monkeypatch, scatter):
    if scatter:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    adj, _, n = _ring_chords()
    value = tinf.estimated_influence(adj, [1, 2, 3], p=0.1, num_sims=16,
                                     key=3, device="cpu")
    assert value >= 3
    snap = tracing.snapshot()
    recent = snap["recent"]
    top = _one(recent, "ic.estimate")
    assert top["parent"] is None
    # past the table budget the plan stops after its sort (the degrees that
    # choose the cap come from the sorted keys), and the scatter form
    # uploads the directed edges
    want = ["ic.extract", "ic.plan", "ic.upload", "ic.cascade", "ic.read"]
    stages = ("ic.plan.directed", "ic.plan.sort") if scatter else (
        "ic.plan.directed", "ic.plan.sort", "ic.plan.fill")
    plan = _one(recent, "ic.plan")
    assert [r["name"] for r in recent if r["parent"] == plan["id"]] == list(
        stages)
    kids = [r["name"] for r in recent if r["parent"] == top["id"]]
    assert kids == want
    assert all(r["call"] == top["call"] for r in recent)
    assert snap["counters"]["ic.cascades"] == 1
    assert snap["counters"]["ic.steps"] >= 1


@pytest.mark.fast
def test_compile_span_and_counter(monkeypatch, tmp_path):
    """A build that compiles records ``kernel.compile`` and one
    ``kernels.compiled`` a library; one with nothing to compile records
    neither."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build, "_start", lambda name: (None, None, None))
    monkeypatch.setattr(_build, "_finish", lambda *a: "log")
    report = _build.build(["a", "b"])
    assert set(report) == {"a", "b"}
    snap = tracing.snapshot()
    assert snap["spans"]["kernel.compile"]["count"] == 1
    assert snap["counters"]["kernels.compiled"] == 2
    (tmp_path / "liba.so").write_bytes(b"")
    (tmp_path / "libb.so").write_bytes(b"")
    assert _build.build(["a", "b"]) == {}
    assert tracing.snapshot()["spans"]["kernel.compile"]["count"] == 1


# --------------------------------------------------------------------- #
# on the card (skipped without one)
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the replayed step and the cascade "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_layout_records_replay_and_read(cuda_device):
    adj, _, _ = _ring_chords()
    emb = GraphEmbedderTorch(adj, n_components=3, device=cuda_device,
                             seed=4, init="random", knn_strategy="binfold",
                             binned_table=True, verbose=False)
    tracing.reset()
    k1 = bf.knn_binfold.launches
    pos = emb.run_layout(num_iterations=25)
    snap = tracing.snapshot()
    spans, c = snap["spans"], snap["counters"]
    for name in ("layout.call", "layout.first_step", "layout.capture",
                 "layout.read", *READ):
        assert spans[name]["count"] == 1, name
    assert spans["layout.replay"]["count"] == 3
    # one K1 launch an iteration: the eager step's, then one a replay
    assert c["launches.knn_binfold"] == k1 + 25
    # the step's stages ran in Python twice: the eager step, the capture
    for name in STEP:
        assert spans[name]["count"] == 2, name
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        emb.run_layout(num_iterations=10)
    spans = tracing.snapshot()["spans"]
    assert not set(STEP) & set(spans)
    assert spans["layout.replay"]["count"] == 1
    np.testing.assert_array_equal(pos.shape, (adj.shape[0], 3))
    # each span is a host range of its name, and nothing of its name lies
    # on the device's timeline (a user annotation would, over its kernels)
    assert {ev.name for ev in _cpu_events(prof, tuple(spans))} == set(spans)
    device = {ev.name for ev in prof.events()
              if ev.device_type == DeviceType.CUDA}
    assert device and not device & set(spans)


@pytest.mark.cuda
@pytest.mark.parametrize("scatter", [False, True])
def test_card_outcome_and_work_counters(cuda_device, monkeypatch, scatter):
    """On the card the counts, steps and dense steps come back in one read
    of the kernel's control words; under a profiler the work counters equal
    the plain version's stats; without one ``frontier_work`` never runs."""
    if scatter:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    edges, n = _ring_plus_chords()
    mask = _seed_mask(n)
    p, sims, iters, key = 0.1, 32, 200, 11
    (_, counts, steps), stats, _ = _plain(edges, n, mask, p, sims, iters,
                                          key, scatter, cuda_device)
    calls = []
    work = icc.frontier_work

    def counted(*args):
        calls.append(1)
        return work(*args)

    monkeypatch.setattr(tic, "frontier_work", counted)
    seeds = np.flatnonzero(mask)

    def estimate():
        return tic.independent_cascade(edges, n, seeds, p=p, num_sims=sims,
                                       max_iters=iters, key=key,
                                       device=cuda_device)[0]

    np.testing.assert_array_equal(estimate(), counts.numpy())
    c = tracing.snapshot()["counters"]
    assert calls == [] and c["ic.steps"] == int(steps)
    assert 0 <= c["ic.dense_steps"] <= int(steps)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        np.testing.assert_array_equal(estimate(), counts.numpy())
    c = tracing.snapshot()["counters"]
    assert calls == [1]
    assert c["ic.sources"] == stats["sources"]
    assert c["ic.pushed"] == stats["pushed"]
