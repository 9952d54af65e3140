"""``ring_12m.spread`` through the scatter form: its CPU copy (3,000
vertices, where the cap model picks the gather form) run whole with the
table budget at 0 in the program and in the reference, so that both take
the scatter form; and a guard that the configuration takes it at its full
size.

A run passes, its control fails, and every planted fault is caught: the
three of ``test_portbench_faults.py`` and one of the scatter form's own,
the directed edges rolled by E, so that each edge draws its coins under
its reverse's index. The new readers are checked on the same runs and on
counters set by the test."""

import io
import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from conftest import REPO, family
from test_portbench_faults import (_spread_altered, _spread_half,
                                   _spread_unchanged)

from portbench.harness import program_spans as ps, registry
from portbench.harness import trace as tr
from portbench.harness.spans import Spans

CELL = "ring_12m.spread"
READERS = ("ic_over_budget_plan_s_per_estimate",
           "ic_upload_mib_per_estimate")


def _reader(name):
    return registry.reader(REPO, registry.load_benchmark(REPO), name)


@pytest.fixture
def tracing():
    from graphem_rapids_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


@pytest.fixture
def scatter(monkeypatch):
    """The table budget at 0 in the program and in the reference."""
    from graphem_rapids_torch.ops import ic_sim

    from portbench.reference import influence

    monkeypatch.setattr(ic_sim, "TABLE_BUDGET_SLOTS", 0)
    monkeypatch.setattr(influence, "TABLE_BUDGET_SLOTS", 0)


def _run(root, bench, trace=0, control=False):
    """(result, {tag: fields} of the run's log lines) of one CPU run of
    CELL."""
    from portbench.harness import cell

    log = io.StringIO()
    result, _ = cell.run(str(root), bench, CELL, 12345, 0.01, trace, "cpu",
                         time.perf_counter(), control=control, log=log)
    lines = {}
    for line in log.getvalue().splitlines():
        lines.update(json.loads(line))
    return result, lines


def test_scatter_form_run_passes_and_control_fails(bench_root, tracing,
                                                   scatter):
    root, bench = bench_root
    result, lines = _run(root, bench, control=True)
    assert result["correct"] is True and result["failed"] == 0
    assert any(c["fails"] for c in result["control"].values())
    assert lines["check"]["ic_form"] == "scatter"
    # every estimate of the run (the warm-up's and the window's) stopped
    # past the budget
    snap = tracing.snapshot()
    estimates = snap["spans"]["ic.estimate"]["count"]
    assert estimates == result["attempted"] + 1
    assert snap["counters"]["ic.plan.over_budget"] == estimates


def _slots_reversed(monkeypatch):
    """The scatter form's directed edges both rolled by E: the same edges,
    each drawing its coins under its reverse's index."""
    from graphem_rapids_torch.ops import ic_sim

    original = ic_sim.directed_edges

    def rolled(edges, device):
        src, dst = original(edges, device)
        half = src.shape[0] // 2
        return src.roll(half), dst.roll(half)

    monkeypatch.setattr(ic_sim, "directed_edges", rolled)


@pytest.mark.parametrize("fault", [_spread_unchanged, _spread_half,
                                   _spread_altered, _slots_reversed])
def test_scatter_form_fault_is_caught(bench_root, monkeypatch, scatter,
                                      fault):
    root, bench = bench_root
    fault(monkeypatch)
    result, lines = _run(root, bench)
    assert lines["check"]["ic_form"] == "scatter"
    assert result["correct"] is False


def test_readers_on_traced_runs_of_both_forms(bench_root, tracing,
                                              monkeypatch):
    """Past the budget the plan reader gives the program's ``ic.plan``
    seconds inside the window's estimates, per estimate; below it, and for
    the upload reader on the CPU (nothing copied), no reading."""
    root, bench = bench_root
    result, lines = _run(root, bench, trace=1)
    assert lines["check"]["ic_form"] == "gather"
    assert result["correct"] is True
    assert not set(READERS) & set(result["metrics"])

    from graphem_rapids_torch.ops import ic_sim

    from portbench.reference import influence

    monkeypatch.setattr(ic_sim, "TABLE_BUDGET_SLOTS", 0)
    monkeypatch.setattr(influence, "TABLE_BUDGET_SLOTS", 0)
    tracing.reset()
    result, lines = _run(root, bench, trace=1)
    assert lines["check"]["ic_form"] == "scatter"
    assert result["correct"] is True
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert "ic_upload_mib_per_estimate" not in m
    snap = tracing.snapshot()
    calls = [r for r in snap["recent"] if r["name"] == "ic.estimate"][1:]
    assert len(calls) == result["attempted"] >= 1
    ids = {r["id"] for r in calls}
    want = sum(r["end_ns"] - r["start_ns"] for r in snap["recent"]
               if r["name"] == "ic.plan" and r["parent"] in ids)
    assert m["ic_over_budget_plan_s_per_estimate"] == pytest.approx(
        want / 1e9 / len(calls))


def _record(kind, trace=True, spans=None):
    return SimpleNamespace(
        kind=kind, spans=spans or Spans(), facts={},
        window={"calls": 1, "work": 1, "seconds": 1.0},
        trace=tr.Trace(window=(0, 1)) if trace else None, setup_s=1.0,
        peak_bytes=0)


def _estimates(tracing, count, over_budget):
    """A run's record with ``count`` window estimates, each with a program
    ``ic.estimate`` holding an ``ic.plan``, ``over_budget`` of the plans
    counted past the budget."""
    spans = Spans()
    for k in range(count):
        with spans.span("ic.estimate"), tracing.span("ic.estimate"):
            with tracing.span("ic.plan"):
                pass
            if k < over_budget:
                tracing.count("ic.plan.over_budget")
    return _record("spread", spans=spans)


def test_upload_reader_from_the_counters(tracing):
    run = _estimates(tracing, 3, 3)
    read = _reader("ic_upload_mib_per_estimate")
    assert read(run) is None  # nothing copied
    tracing.count("ic.upload.bytes", 3 * 2 * 8 * 48_000_000)
    assert read(run) == pytest.approx(2 * 8 * 48_000_000 / 2**20)


@pytest.mark.parametrize("over_budget", [0, 2])
def test_plan_reader_none_unless_every_plan_stopped(tracing, over_budget):
    """A run in which some plan was built (or none stopped) reads None."""
    run = _estimates(tracing, 3, over_budget)
    assert _reader("ic_over_budget_plan_s_per_estimate")(run) is None


@pytest.mark.parametrize("name", READERS)
def test_new_readers_none_outside_their_kind_or_trace(tracing, name):
    _estimates(tracing, 2, 2)
    tracing.count("ic.upload.bytes", 1 << 20)
    read = _reader(name)
    spans = Spans()
    with spans.span("ic.estimate"):
        pass
    for kind in ("layout", "spread", "other"):
        for trace in (False, True):
            if kind == "spread" and trace:
                continue
            assert read(_record(kind, trace, spans)) is None


@pytest.mark.parametrize("name", READERS)
def test_new_readers_none_without_the_program_module(tracing, monkeypatch,
                                                     name):
    """A program without ``utils.tracing`` (an older checkout): nothing to
    read, and no reader raises."""
    import graphem_rapids_torch.utils as utils

    run = _estimates(tracing, 2, 2)
    tracing.count("ic.upload.bytes", 1 << 20)

    monkeypatch.setitem(sys.modules, "graphem_rapids_torch.utils.tracing",
                        None)
    monkeypatch.delattr(utils, "tracing")
    assert ps.snapshot() is None
    assert _reader(name)(run) is None


def test_ring_12m_takes_the_scatter_form_at_full_size():
    """At 12M vertices the ring family's degrees (the ring's 2 a vertex and
    36M uniform chords, self loops dropped and duplicates merged, as the
    harness merges them) give a table cap of 13 in the port and in the
    reference: n * cap = 156M slots, past the 2^27 budget."""
    from graphem_rapids_torch.ops import ic_sim
    from graphem_rapids_torch.ops.forces import _optimal_table_cap

    from portbench.reference import influence
    from portbench.reference.tables import optimal_table_cap

    bench = registry.load_benchmark(REPO)
    spec = registry.config(REPO, bench, "ring_12m")["graph"]
    n = int(spec["vertices"])
    gen = torch.Generator()
    gen.manual_seed(2**31 + 12345)
    a, b = family(spec["family"])(n, int(spec["chords"]), spec, gen, "cpu")
    keep = a != b
    lo, hi = torch.minimum(a, b)[keep], torch.maximum(a, b)[keep]
    del a, b, keep
    # a chord along the ring is one of its edges
    off_ring = (hi - lo != 1) & ~((lo == 0) & (hi == n - 1))
    key = torch.unique(lo[off_ring] * n + hi[off_ring])
    del lo, hi, off_ring
    deg = (torch.bincount(key // n, minlength=n)
           + torch.bincount(key % n, minlength=n) + 2).numpy()
    del key
    assert deg.sum() > 2 * 47_000_000
    cap = _optimal_table_cap(deg, n)
    assert cap == optimal_table_cap(deg, n) == 13
    assert n * cap > ic_sim.TABLE_BUDGET_SLOTS == influence.TABLE_BUDGET_SLOTS


def test_new_readers_listed_for_their_cells():
    """A traced run of the cell reports both new readers; the other spread
    cell lists the upload reader alone."""
    bench = registry.load_benchmark(REPO)
    names = {m["name"] for m in registry.metrics(bench, CELL, 1)}
    assert set(READERS) <= names
    other = {m["name"] for m in registry.metrics(bench, "skewed_1m.spread",
                                                 1)}
    assert "ic_upload_mib_per_estimate" in other
    assert "ic_over_budget_plan_s_per_estimate" not in other
