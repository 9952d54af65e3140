"""The spread estimate's counters of the table budget and the edges' upload
(``ops/ic_sim.py``): ``ic.plan.over_budget`` counts the plans that stop past
``TABLE_BUDGET_SLOTS``, ``ic.upload.bytes`` the bytes of edges copied to a
device they were not on. On the CPU the copy is checked on the meta device;
the card's tests skip without a card (``-m cuda``)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch import influence as tinf
from graphem_rapids_torch.ops import ic_sim as tic
from graphem_rapids_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _ring_chords(n=2000, chords=6000, seed=0):
    """(scipy CSR adjacency, (E, 2) int32 i < j edges, n) of a ring on n
    vertices plus uniform chords."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.arange(n), rng.integers(0, n, chords)])
    b = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, chords)])
    keep = a != b
    lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    e = np.unique(np.stack([lo, hi], 1), axis=0).astype(np.int32)
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                        shape=(n, n)).tocsr()
    return (adj + adj.T).tocsr(), e, n


def _counter(name):
    return tracing.snapshot()["counters"].get(name, 0)


@pytest.mark.fast
@pytest.mark.parametrize("over", [False, True])
def test_over_budget_counts_each_plan_past_the_budget(monkeypatch, over):
    """One ``ic.plan.over_budget`` a plan past the budget, none below it;
    nothing leaves the host on the CPU, so no upload bytes."""
    if over:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    adj, _, _ = _ring_chords()
    for key in range(3):
        tinf.estimated_influence(adj, [1, 2, 3], num_sims=16, key=key,
                                 device="cpu")
    snap = tracing.snapshot()
    assert snap["spans"]["ic.plan"]["count"] == 3
    assert _counter("ic.plan.over_budget") == (3 if over else 0)
    assert _counter("ic.upload.bytes") == 0


@pytest.mark.fast
def test_upload_bytes_count_a_copy_to_another_device():
    """The receivers' upload counts the bytes of the edges as copied (int32
    8E, int64 16E) where it copies them to another device (meta here),
    and nothing where the edges stay where they are."""
    _, e, _ = _ring_chords(n=300, chords=600)
    E = len(e)
    tic._dst_list(e, "cpu")
    tic._dst_list(torch.as_tensor(e), None)
    tic._dst_list(torch.as_tensor(e), "cpu")
    assert _counter("ic.upload.bytes") == 0
    tic._dst_list(e, "meta")
    assert _counter("ic.upload.bytes") == 8 * E
    tic._dst_list(e.astype(np.int64), "meta")
    assert _counter("ic.upload.bytes") == 8 * E + 16 * E
    src, dst = tic.directed_edges(e, "meta")
    assert src.device.type == dst.device.type == "meta"
    assert _counter("ic.upload.bytes") == 2 * 8 * E + 16 * E


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cascade kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("over", [False, True])
def test_card_estimate_uploads_the_edges_once_or_twice(cuda_device,
                                                       monkeypatch, over):
    """An estimate from numpy edges copies them to the card once (8E bytes)
    in the gather form, twice (16E) past the budget: the plan's upload and
    the scatter form's own."""
    if over:
        monkeypatch.setattr(tic, "TABLE_BUDGET_SLOTS", 0)
    _, e, n = _ring_chords()
    for key in range(2):
        tic.estimated_influence(e, n, [1, 2, 3], num_sims=32, key=key,
                                device=cuda_device)
    assert _counter("ic.plan.over_budget") == (2 if over else 0)
    assert _counter("ic.upload.bytes") == 2 * (16 if over else 8) * len(e)
    # edges already on the card are not copied
    on_card = torch.as_tensor(e, device=cuda_device)
    tic.cascade_plan_arrays(on_card, n)
    tic.directed_edges(on_card, cuda_device)
    assert _counter("ic.upload.bytes") == 2 * (16 if over else 8) * len(e)
