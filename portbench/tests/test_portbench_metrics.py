"""The metric arithmetic on fixed inputs."""

import pytest

from portbench.harness import kernels, peaks, trace as tr, traffic
from portbench.harness.spans import Spans


def test_k1_bound_from_shapes():
    # the heavy-tail graph's fused refs: compute-bound, 0.658 ms
    s = peaks.k1_bound_s(512, 3_909_666, 3, 16)
    assert s == pytest.approx(512 * 3_909_666 * 11 / 33.45e12, rel=1e-3)
    assert s * 1e3 == pytest.approx(0.658, abs=0.001)
    # one query against few refs: bound by the bytes
    s = peaks.k1_bound_s(1, 1000, 3, 16)
    assert s == pytest.approx((4 * 3 * 1001 + 8 * 16) / 3.35e12)
    assert peaks.FP32_INSTR_PER_S == pytest.approx(33.45e12, rel=1e-3)


def test_union_counts_overlaps_once():
    assert tr.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 11)]) == [
        (0, 3), (5, 9), (10, 11)]
    t = tr.Trace(window=(0, 20), device=[
        ("a", 0, 2), ("b", 1, 3), ("c", 5, 7), ("d", 6, 9)])
    assert tr.busy_seconds(t) == pytest.approx(7e-6)
    assert tr.gaps(t) == [(3, 5), (9, 20)]


def test_idle_gaps_named_by_innermost_span():
    t = tr.Trace(window=(0, 100), device=[("k", 0, 10), ("k", 50, 60)],
                 spans=[("call", 0, 100), ("read", 60, 100),
                        ("plan", 10, 50)])
    assert tr.idle_by_span(t) == [["plan", 40e-6], ["read", 40e-6]]
    assert tr.device_time_by_name(t) == [["k", 20e-6]]


def test_device_seconds_by_name_and_span():
    t = tr.Trace(window=(0, 100), device=[
        ("binfold_kernel<3>", 0, 10), ("static_sum_kernel<long>", 10, 12),
        ("Memcpy DtoH", 12, 20), ("index_kernel", 20, 30)],
        spans=[("ic.cascade", 0, 10.5)])
    assert tr.device_seconds(t, kernels.is_k1) == pytest.approx(10e-6)
    assert tr.device_seconds(t, kernels.is_accumulator) == pytest.approx(2e-6)
    assert tr.device_seconds(t, kernels.is_step_pass) == pytest.approx(10e-6)
    assert tr.device_seconds(t, within=("ic.cascade",)) == pytest.approx(
        10e-6)


def test_rate_over_whole_calls(monkeypatch):
    clock = iter([0.0, 0.4, 0.8, 1.2, 1.6])
    monkeypatch.setattr(traffic.time, "perf_counter", lambda: next(clock))
    w = traffic.closed_loop(lambda: 10, seconds=1.0)
    # three whole calls, the last one let finish past the second
    assert w["calls"] == 3 and w["work"] == 30
    assert w["seconds"] == pytest.approx(1.2)
    assert w["work"] / w["seconds"] == pytest.approx(25.0)


def test_spans_wrap_and_restore():
    class Owner:
        @staticmethod
        def f(x):
            return x + 1

    spans = Spans()
    with spans.wrap([(Owner, "f", "f")]):
        assert Owner.f(1) == 2
    assert Owner.f(2) == 3 and spans.count("f") == 1
