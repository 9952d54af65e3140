"""The engine's fused blocks on a card: CUDA-graph replay against eager.

On a CUDA device ``GraphEmbedderTorch.run_layout`` runs the first iteration
eagerly, captures one iteration (the sample from the engine's generator,
then the step into a static positions buffer) and replays it. These tests
hold the replayed trajectory against the eager loop from the same generator
state, bit for bit with the engine's own deterministic sums; the
positions setter and ``load_checkpoint`` under a captured graph; and the
K1/K2 launch counters, which must count one launch per replayed iteration.
They need a card (marked ``cuda``) and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_replay.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch import GraphEmbedderTorch
from graphem_rapids_torch.ops import knn_binfold, knn_pallas

PARAMS = dict(n_components=3, L_min=10.0, k_attr=0.5, k_inter=0.1,
              n_neighbors=8, sample_size=128, verbose=False, seed=3,
              init="random")
# strategy -> the kernel counter that must count one launch per iteration
STRATEGIES = {
    "binfold": knn_binfold.knn_binfold,
    "pallas": knn_pallas.knn_pallas,
    "exact": None,
    "approx": None,
}


def regular_graph(n=2000, cycles=3, seed=1):
    rng = np.random.default_rng(seed)
    e = []
    for _ in range(cycles):
        p = rng.permutation(n)
        e.append(np.column_stack([p, np.roll(p, -1)]))
    e = np.concatenate(e)
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager(emb, n):
    """``n`` iterations of the eager loop, drawn from the engine's
    generator; returns each iteration's sample."""
    out = []
    for _ in range(n):
        s = emb._sample()
        out.append(s.cpu().numpy())
        emb._positions = emb._raw_step(emb._positions, s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("ref_order", ["row", "slot"])
def test_replay_matches_eager(cuda_device, strategy, ref_order):
    adj = regular_graph()
    kw = dict(PARAMS, knn_strategy=strategy, ref_order=ref_order)
    replayed = GraphEmbedderTorch(adj, device=cuda_device, **kw)
    eager = GraphEmbedderTorch(adj, device=cuda_device, **kw)
    replayed.run_layout(1)  # the eager first iteration, then the capture
    want = _eager(eager, 1)
    for _ in range(4):
        replayed.run_layout(1)
        want += _eager(eager, 1)
        np.testing.assert_array_equal(replayed._graph_sample.cpu().numpy(),
                                      want[-1])
    assert replayed._graph is not None and eager._graph is None
    np.testing.assert_array_equal(replayed.positions, eager.positions)
    assert torch.equal(replayed._generator.get_state(),
                       eager._generator.get_state())


@pytest.mark.cuda
def test_setter_and_checkpoint_under_graph(cuda_device, tmp_path):
    adj = regular_graph()
    kw = dict(PARAMS, knn_strategy="binfold")
    a = GraphEmbedderTorch(adj, device=cuda_device, **kw)
    a.run_layout(3)
    assert a._graph is not None
    start = np.random.default_rng(0).standard_normal(
        (a.n, 3)).astype(np.float32)
    a.positions = start
    np.testing.assert_array_equal(a.positions, start)
    path = tmp_path / "state.npz"
    a.save_checkpoint(path)
    a.run_layout(4, block_size=2)
    b = GraphEmbedderTorch(adj, device=cuda_device, **{**kw, "seed": 9})
    b.load_checkpoint(path)
    assert b._graph is None
    b.run_layout(4)
    np.testing.assert_array_equal(a.positions, b.positions)
    # the same checkpoint loaded under a's captured graph
    a.load_checkpoint(path)
    np.testing.assert_array_equal(a.positions, start)
    a.run_layout(4)
    np.testing.assert_array_equal(a.positions, b.positions)
    # an injected sample runs eagerly into the graph's buffer
    s = np.arange(a.sample_size)
    a.update_positions(sample_indices=s)
    b.update_positions(sample_indices=s)
    a.update_positions()
    b.update_positions()
    np.testing.assert_array_equal(a.positions, b.positions)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["binfold", "pallas"])
def test_launch_counters_under_replay(cuda_device, strategy):
    counter = STRATEGIES[strategy]
    emb = GraphEmbedderTorch(regular_graph(), device=cuda_device,
                             **dict(PARAMS, knn_strategy=strategy))
    counter.launches = 0
    emb.run_layout(7, block_size=3)
    assert counter.launches == 7
    emb.update_positions()
    assert counter.launches == 8
    other = knn_pallas.knn_pallas if strategy == "binfold" \
        else knn_binfold.knn_binfold
    other.launches = 0
    emb.run_layout(5)
    assert counter.launches == 13 and other.launches == 0


@pytest.mark.cuda
def test_capture_failure_raises(cuda_device, monkeypatch):
    """A step that syncs with the host cannot be captured: run_layout
    raises, and never carries on eagerly."""
    emb = GraphEmbedderTorch(regular_graph(), device=cuda_device,
                             **dict(PARAMS, knn_strategy="exact"))
    raw = emb._raw_step

    def syncing(positions, sampled):
        float(positions.sum())
        return raw(positions, sampled)

    monkeypatch.setattr(emb, "_raw_step", syncing)
    with pytest.raises(RuntimeError):
        emb.run_layout(3)
    assert emb._graph is None
