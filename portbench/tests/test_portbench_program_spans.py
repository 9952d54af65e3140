"""The readers of the program's own spans and counters
(``harness/program_spans.py`` and the metrics that read it), on CPU runs of
``cell.run`` and on fixed inputs."""

import sys
from types import SimpleNamespace

import pytest
from conftest import REPO, run_cpu

from portbench.harness import peaks, program_spans as ps, registry
from portbench.harness import trace as tr
from portbench.harness.spans import Spans

NEW = ("positions_read_ms", "program_tables_s", "program_spectral_s",
       "program_ic_host_s_per_estimate", "ic_cascade_roofline")


def _reader(name):
    return registry.reader(REPO, registry.load_benchmark(REPO), name)


@pytest.fixture
def tracing():
    from graphem_rapids_torch.utils import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def _agrees(program, outside, rel, abs_s):
    return abs(program - outside) <= max(rel * outside, abs_s)


@pytest.mark.parametrize("cell_name", ["skewed_1m.layout", "ring_10m.layout"])
def test_layout_readers_on_a_traced_cpu_run(bench_root, tracing, cell_name):
    root, bench = bench_root
    result, _ = run_cpu(root, bench, cell_name, trace=1)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert {"positions_read_ms", "program_tables_s",
            "program_spectral_s"} <= set(m)
    assert "program_ic_host_s_per_estimate" not in m
    assert "ic_cascade_roofline" not in m
    assert _agrees(m["program_tables_s"], m["tables_s"], 0.01, 0.005)
    assert _agrees(m["program_spectral_s"], m["spectral_s"], 0.01, 0.005)
    # the read of the window's one call (traced_calls = 1), and not the
    # set-up's read of the start, the warm-up's or the check's two
    snap = tracing.snapshot()
    reads = [r for r in snap["recent"] if r["name"] == "layout.read"]
    assert len(reads) == 5
    window = reads[2]["id"]
    want = sum(r["end_ns"] - r["start_ns"] for r in snap["recent"]
               if r["parent"] == window
               and r["name"] in ("layout.read.copy", "layout.read.permute"))
    assert m["positions_read_ms"] == pytest.approx(want / 1e6)


def test_spread_reader_on_a_traced_cpu_run(bench_root, tracing):
    root, bench = bench_root
    result, _ = run_cpu(root, bench, "skewed_1m.spread", trace=1)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert "program_ic_host_s_per_estimate" in m
    # on the CPU the cascade has no push lists and no kernel to time
    assert "ic_cascade_roofline" not in m
    assert not {"positions_read_ms", "program_tables_s",
                "program_spectral_s"} & set(m)
    assert _agrees(m["program_ic_host_s_per_estimate"],
                   m["ic_host_s_per_estimate"], 0.02, 0.001)


def _record(kind, trace=True, spans=None, facts=None):
    return SimpleNamespace(
        kind=kind, spans=spans or Spans(), facts=facts or {},
        window={"calls": 1, "work": 1, "seconds": 1.0},
        trace=tr.Trace(window=(0, 1)) if trace else None, setup_s=1.0,
        peak_bytes=0)


@pytest.mark.parametrize("name", NEW)
def test_readers_none_outside_their_kind_or_trace(tracing, name):
    read = _reader(name)
    for kind in ("layout", "spread", "other"):
        for trace in (False, True):
            assert read(_record(kind, trace)) is None


def test_readers_none_without_the_program_module(tracing, monkeypatch):
    """A program without ``utils.tracing`` (an older checkout): nothing to
    read, and no reader raises."""
    spans = Spans()
    with spans.span("tables"), spans.span("spectral"):
        with tracing.span("setup.tables"), tracing.span("setup.spectral"):
            pass
    import graphem_rapids_torch.utils as utils

    monkeypatch.setitem(sys.modules, "graphem_rapids_torch.utils.tracing",
                        None)
    monkeypatch.delattr(utils, "tracing")
    assert ps.snapshot() is None
    for name in NEW:
        for kind in ("layout", "spread"):
            assert _reader(name)(_record(kind, spans=spans)) is None


def _spread_run(tracing, estimates=3, stats=3, extra=0, kernel_us=300_000.0):
    """A traced spread run's record with ``estimates`` window estimates,
    the first ``stats`` of them counted (an ic.stats span each), and
    ``extra`` counted cascades outside the window."""
    spans = Spans()
    for _ in range(extra):
        with tracing.span("ic.stats"):
            pass
    for k in range(estimates):
        with spans.span("ic.estimate"):
            if k < stats:
                with tracing.span("ic.stats"):
                    pass
    tracing.count("ic.sources", 1000)
    tracing.count("ic.pushed", 50_000)
    device = [("(anonymous namespace)::ic_cascade_kernel(ic::Cascade)",
               k * 1e6, k * 1e6 + kernel_us) for k in range(estimates)]
    device.append(("Memcpy HtoD (Pageable -> Device)", 0.0, 5e5))
    run = _record("spread", spans=spans,
                  facts={"n": 1_000_000, "E": 3_000_000, "num_sims": 64})
    run.trace = tr.Trace(window=(0, 4e6), device=device)
    return run


def test_ic_cascade_roofline_from_the_counters(tracing):
    read = _reader("ic_cascade_roofline")
    got = read(_spread_run(tracing))
    n, B, W = 1_000_000, 64, 2
    work = 3 * (4 * (2 * n * W + B + 1) + 16) + 8 * (1000 + 50_000)
    assert got == pytest.approx(
        100 * work / peaks.HBM_BYTES_PER_S / 0.9)
    assert 0 < got < 100


@pytest.mark.parametrize("stats,extra", [(2, 0), (3, 1)])
def test_ic_cascade_roofline_none_when_the_counts_are_not_the_window(
        tracing, stats, extra):
    """An estimate whose cascade went uncounted (capped), or counts from a
    cascade outside the window: no reading."""
    read = _reader("ic_cascade_roofline")
    assert read(_spread_run(tracing, stats=stats, extra=extra)) is None
