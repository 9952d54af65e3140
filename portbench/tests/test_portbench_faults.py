"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run on the CPU (the look for a card skipped) with
one fault planted in the program, and sees ``correct`` false: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced; at the layout cells also the same sample drawn every
iteration, and a stage of block sums left out of the hubs' long runs in
the static sum. (A cell on one card has no exchange between cards to
leave out.) The control, the reference in bfloat16 in the program's place,
fails too; a sound run passes.
"""

import numpy as np
import pytest
import torch
from conftest import cells, run_cpu


@pytest.mark.parametrize("cell_name", cells())
def test_sound_run_passes_and_control_fails(bench_root, cell_name):
    root, bench = bench_root
    result, _ = run_cpu(root, bench, cell_name, control=True)
    assert result["correct"] is True
    assert any(c["fails"] for c in result["control"].values())


def _unchanged(monkeypatch):
    from graphem_rapids_torch.models import embedder as em

    monkeypatch.setattr(em.GraphEmbedderTorch, "_raw_step",
                        lambda self, positions, sampled: positions.clone())


def _half_batch(monkeypatch):
    from graphem_rapids_torch.models import embedder as em

    original = em.intersection_forces

    def half(positions, edges, knn_indices, sampled, k_inter, **kw):
        h = sampled.shape[0] // 2
        return original(positions, edges, knn_indices[:h], sampled[:h],
                        k_inter, **kw)

    monkeypatch.setattr(em, "intersection_forces", half)


def _altered(monkeypatch):
    from graphem_rapids_torch.models import embedder as em

    original = em.GraphEmbedderTorch._raw_step

    def altered(self, positions, sampled):
        out = original(self, positions, sampled)
        out[7, 1] += 0.01 * out.abs().max()  # no host read: it is captured
        return out

    monkeypatch.setattr(em.GraphEmbedderTorch, "_raw_step", altered)


def _same_sample(monkeypatch):
    from graphem_rapids_torch.models import embedder as em

    original = em.sample_indices
    first = {}

    def same(generator, n_items, n_samples, device=None):
        if "sample" not in first:  # the first draw, made eagerly
            first["sample"] = original(generator, n_items, n_samples,
                                       device=device)
        return first["sample"]

    monkeypatch.setattr(em, "sample_indices", same)


# a stage of the static sum's long runs: 128 block sums
STAGE = 128


def _stage_skipped(monkeypatch):
    """The hub plan's sum leaves out one stage of block sums (at most half
    of it) from the middle of its longest run."""
    from graphem_rapids_torch.ops import forces

    original = forces.segment_sum_sorted
    where = {}

    def skipped(out, keys, values, perm=None):
        if perm is None and keys.shape[0] == values.shape[0] > 1:
            k = id(keys)
            if k not in where:  # first met eagerly, before any capture
                _, counts = torch.unique_consecutive(keys,
                                                     return_counts=True)
                ends = torch.cumsum(counts, 0)
                i = int(counts.argmax())
                run = int(counts[i])
                skip = min(STAGE, run // 2)
                start = int(ends[i]) - run + (run - skip) // 2
                where[k] = (start, start + skip)
            a, b = where[k]
            values = values.clone()
            values[a:b] = 0
        return original(out, keys, values, perm)

    monkeypatch.setattr(forces, "segment_sum_sorted", skipped)


def _over(result):
    return [k for k, c in result["compared"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell_name", cells("layout"))
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _same_sample])
def test_layout_fault_is_caught(bench_root, monkeypatch, cell_name, fault):
    root, bench = bench_root
    fault(monkeypatch)
    result, _ = run_cpu(root, bench, cell_name)
    assert result["correct"] is False
    assert _over(result)


def test_hub_stage_left_out_is_caught(bench_root, monkeypatch):
    """At the heavy-tail graph the hub rows' gap finds a stage of block
    sums left out of a long run."""
    root, bench = bench_root
    _stage_skipped(monkeypatch)
    result, _ = run_cpu(root, bench, "skewed_1m.layout")
    assert result["correct"] is False
    assert "hub_gap" in _over(result)


def _spread_unchanged(monkeypatch):
    from graphem_rapids_torch import influence as inf

    def no_step(edges, n, seeds, num_sims=64, **kw):
        return np.full(num_sims, len(list(seeds)), np.int32), 0

    monkeypatch.setattr(inf, "independent_cascade", no_step)


def _spread_half(monkeypatch):
    from graphem_rapids_torch import influence as inf

    original = inf.independent_cascade

    def half(*args, **kw):
        counts, iters = original(*args, **kw)
        return counts[:len(counts) // 2], iters

    monkeypatch.setattr(inf, "independent_cascade", half)


def _spread_altered(monkeypatch):
    from graphem_rapids_torch import influence as inf

    original = inf.estimated_influence
    monkeypatch.setattr(inf, "estimated_influence",
                        lambda *a, **kw: original(*a, **kw) + 1.0 / 64)


@pytest.mark.parametrize("cell_name", cells("spread"))
@pytest.mark.parametrize("fault", [_spread_unchanged, _spread_half,
                                   _spread_altered])
def test_spread_fault_is_caught(bench_root, monkeypatch, cell_name, fault):
    root, bench = bench_root
    fault(monkeypatch)
    result, _ = run_cpu(root, bench, cell_name)
    assert result["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", cells())
def test_control_fails_on_the_card(bench_root, cell_name):
    """The control at a test's size on the card: the program passes, the
    reference in bfloat16 in its place does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root, bench = bench_root
    result, loaded = run_cpu(root, bench, cell_name, control=True,
                             device="cuda")
    assert result["correct"] is True and loaded == []
    assert any(c["fails"] for c in result["control"].values())
