"""The exact tiled kNN ('pallas') of the PyTorch port against the JAX kernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version
(knn_tiled_reference); the JAX kernel runs in Pallas interpret mode, which
knn_pallas selects by itself off a TPU. Inputs are made with numpy from
fixed seeds. Indices must be equal exactly, ties included (both keep the
smaller index). Values are held at rtol=1e-6: both accumulate the
per-coordinate sum in the same order in fp32, but the JAX interpreter's
compiled elementwise code may round a product-sum differently in the last
bit. The CUDA kernel itself is compared with the plain version, bit for
bit, by the tests marked ``cuda``, which need a card. The card's machine
has no JAX, so the JAX package is imported inside the tests that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_pallas.py
"""

import importlib

import numpy as np
import pytest
import torch

from graphem_rapids_torch.ops import knn_pallas as tkp

# the ops package binds the name knn to the function
tknn = importlib.import_module("graphem_rapids_torch.ops.knn")


def _jax_knn_pallas():
    jnp = pytest.importorskip("jax.numpy")
    jkp = pytest.importorskip("graphem_rapids_tpu.ops.knn_pallas")
    return jnp, jkp.knn_pallas


def _inputs(S, E, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, d)).astype(np.float32) * 10
    r = rng.normal(size=(E, d)).astype(np.float32) * 10
    return q, r


def _with_ties(S, E, d, seed=1):
    """Every ref duplicated once (exact ties), and some queries sitting on
    a ref (a tie at distance 0)."""
    q, r = _inputs(S, E // 2, d, seed)
    r = np.repeat(r, 2, axis=0)
    q[:4] = r[[0, 6, 10, 40]]
    return q, r


def _with_pads(S, E, d, finite=5, seed=2):
    """1e30 pad rows (squared distance +inf) with fewer finite refs than k."""
    q, r = _inputs(S, E, d, seed)
    keep = np.random.default_rng(seed).choice(E, finite, replace=False)
    pads = np.full_like(r, 1e30)
    pads[keep] = r[keep]
    pads[keep[1]] = pads[keep[0]]  # one exact tie among the finite refs
    return q, pads


CASES = {
    # name: (inputs, k)
    "random_d3": (lambda: _inputs(64, 5000, 3), 16),
    "ragged_d3": (lambda: _inputs(33, 3001, 3, seed=3), 8),
    "ties_d2": (lambda: _with_ties(16, 2000, 2), 9),
    "pads_fewer_than_k": (lambda: _with_pads(8, 1500, 3), 12),
    "k1_d4": (lambda: _inputs(16, 2500, 4, seed=4), 1),
    "k128_d3": (lambda: _inputs(16, 2000, 3, seed=5), 128),
    "d4": (lambda: _inputs(24, 1800, 4, seed=6), 20),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(monkeypatch, name):
    jnp, j_knn_pallas = _jax_knn_pallas()
    make, k = CASES[name]
    q, r = make()
    ji, jv = j_knn_pallas(jnp.asarray(q), jnp.asarray(r), k)
    launches = tkp.knn_pallas.launches
    ti, tv = tkp.knn_pallas(torch.from_numpy(q), torch.from_numpy(r), k)
    assert tkp.knn_pallas.launches == launches  # the CPU runs no kernel
    assert ti.dtype == torch.int32 and ti.shape == (q.shape[0], k)
    assert tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    # the reference's chunking is invisible: one chunk or many, same answer
    monkeypatch.setattr(tkp, "_REF_CHUNK", 97)
    ci, cv = tkp.knn_tiled_reference(torch.from_numpy(q), torch.from_numpy(r),
                                     k)
    assert torch.equal(ci, ti) and torch.equal(cv, tv)


@pytest.mark.fast
def test_pad_rule_example():
    """295 refs at 1e30 and 5 finite refs, two of them equal (5 and 7):
    the finite refs in (value, index) order, then (3.0e38, 0)."""
    q = torch.zeros((1, 3))
    r = torch.full((300, 3), 1e30)
    for i, v in zip([50, 120, 77, 299, 5], [0.1, 0.2, 0.3, 0.4, 0.5]):
        r[i] = torch.tensor([v, 0.0, 0.0])
    r[7] = r[5]
    idx, vals = tkp.knn_pallas(q, r, 9, tile=128)
    assert idx.tolist() == [[50, 120, 77, 299, 5, 7, 0, 0, 0]]
    assert (vals[0, 6:] == 3.0e38).all()
    assert torch.equal(vals[0, :6], (r[[50, 120, 77, 299, 5, 7], 0]) ** 2)


@pytest.mark.fast
def test_matches_exact_and_dispatch():
    """Tie-free inputs: the same neighbours as the port's knn_exact, and the
    'pallas' strategy of knn() is this function."""
    q, r = _inputs(40, 3000, 3, seed=8)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    ei, ev = tknn.knn_exact(qt, rt, 11)
    pi, pv = tknn.knn(qt, rt, 11, strategy="pallas")
    assert torch.equal(pi, ei) and torch.equal(pv, ev)
    ti, _ = tkp.knn_pallas(qt, rt, 11, tile=4096)  # tile does not matter
    assert torch.equal(ti, pi)


@pytest.mark.fast
def test_limits_and_wrapper_guards():
    q = torch.zeros((4, 3))
    r = torch.zeros((300, 3))
    with pytest.raises(ValueError, match="k <= 128"):
        tkp.knn_pallas(q, r, 129)
    before = tkp.knn_pallas.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkp.knn_tiled_cuda(q, r, 5)  # no host pointers reach the kernel
    assert tkp.knn_pallas.launches == before
    # fewer refs than k: every slot past E holds (3.0e38, 0)
    idx, vals = tkp.knn_pallas(q, r[:3], 5)
    assert idx[0].tolist() == [0, 1, 2, 0, 0]
    assert (vals[0, :3] == 0).all() and (vals[0, 3:] == 3.0e38).all()


@pytest.mark.fast
@pytest.mark.parametrize("S,E,bps", [(512, 399_984, 3), (512, 3_999_991, 3),
                                     (7, 9001, 3), (1, 100, 1),
                                     (5000, 50_000, 3), (500, 399_984, 2),
                                     (65, 1_000_000, 4)])
def test_slice_plan_covers_refs(S, E, bps):
    """Slices cover every ref exactly once, and the pass-1 grid is at most
    one wave of the resident blocks unless the query blocks alone exceed
    it."""
    n_slices, slice_len = tkp.slice_plan(S, E, sm_count=132,
                                         blocks_per_sm=bps)
    assert slice_len % tkp._SLICE_ALIGN == 0
    assert 1 <= n_slices <= 65535
    assert (n_slices - 1) * slice_len < E <= n_slices * slice_len
    assert n_slices == 1 or 2 * slice_len >= tkp._MIN_SLICE
    q_blocks = -(-S // tkp.QUERIES_PER_BLOCK)
    assert q_blocks * n_slices <= max(q_blocks, 132 * bps)
    if (S, E) == (512, 399_984) and bps == 3:  # 16 query blocks x 24 slices
        assert (q_blocks, n_slices) == (16, 24)


def _tied_across_slices(S, E, d, n_slices, slice_len, seed=9):
    """Each slice's first ref equals the previous slice's last, and some
    queries sit on such a pair: ties at distance 0 across the boundary."""
    q, r = _inputs(S, E, d, seed)
    cuts = [p * slice_len for p in range(1, n_slices)]
    for c in cuts:
        r[c] = r[c - 1]
    for i, c in enumerate(cuts[:S]):
        q[i] = r[c]
    return q, r


SLICED = {
    # name: (inputs, k, n_slices, slice_len)
    "k1_three_slices": (lambda: _inputs(20, 3000, 3, seed=10), 1, 3, 1024),
    "k17_ragged_S": (lambda: _inputs(67, 3000, 3, seed=11), 17, 5, 640),
    "k33": (lambda: _inputs(9, 4000, 2, seed=12), 33, 4, 1024),
    "k128": (lambda: _inputs(5, 2000, 3, seed=13), 128, 3, 700),
    "ties_across_slices": (lambda: _tied_across_slices(16, 4096, 3, 4, 1024),
                           16, 4, 1024),
    "fewer_than_k": (lambda: _with_pads(8, 1500, 3), 12, 3, 512),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(SLICED))
def test_slices_merge_to_reference(name):
    """The kernel's two passes, modelled plainly: per-slice lists merged in
    slice order by (value, index) give knn_tiled_reference bit for bit,
    with or without the shared threshold (any bound at or above the final
    k-th value, here the tightest one, where ties sit exactly on it)."""
    make, k, n_slices, slice_len = SLICED[name]
    q, r = make()
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    ri, rv = tkp.knn_tiled_reference(qt, rt, k)
    for threshold in (None, rv[:, -1], rv[:, -1] * 2):
        si, sv = tkp.knn_slices_reference(qt, rt, k, n_slices, slice_len,
                                          threshold)
        assert torch.equal(si, ri) and torch.equal(sv, rv)
    if name == "ties_across_slices":
        assert (rv[:3, :2] == 0).all()  # the tie at distance 0 ...
        assert (ri[:3, 0] < ri[:3, 1]).all()  # ... keeps the smaller index
    if name == "fewer_than_k":
        assert (rv[:, 5:] == 3.0e38).all() and (ri[:, 5:] == 0).all()


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(SLICED))
def test_shown_bound_keeps_the_answer(name):
    """The bound the slices share (each slice's value at rank ceil(k / n),
    the ceil(k / rank)-th smallest of those) is at or above every query's
    k-th value, and pruning each slice's list at it, ties kept, leaves the
    merged answer unchanged."""
    make, k, n_slices, slice_len = SLICED[name]
    q, r = make()
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    ri, rv = tkp.knn_tiled_reference(qt, rt, k)
    lists = torch.stack([
        tkp.knn_tiled_reference(qt, rt[p * slice_len:(p + 1) * slice_len],
                                k)[1] for p in range(n_slices)])
    bound = tkp.shown_bound(lists, k)
    assert (bound >= rv[:, -1]).all()
    si, sv = tkp.knn_slices_reference(qt, rt, k, n_slices, slice_len, bound)
    assert torch.equal(si, ri) and torch.equal(sv, rv)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kNN kernel has no CPU mode")
    return torch.device("cuda")


def _card_tied_across_slices():
    """Ties at distance 0 across every slice boundary of the plan the card
    makes for S=512 against 200,000 refs."""
    dev = torch.device("cuda")
    n_slices, slice_len = tkp.slice_plan(
        512, 200_000, torch.cuda.get_device_properties(dev).multi_processor_count,
        tkp._blocks_per_sm(dev, 3, 16))
    return _tied_across_slices(512, 200_000, 3, n_slices, slice_len)


# the kernel's plan edges, on the card only (the JAX interpreter is slow)
CARD_CASES = {
    **CASES,
    "midpoints_100k": (lambda: _inputs(512, 399_984, 3, seed=20), 16),
    "ties_across_slices": (_card_tied_across_slices, 16),
    "one_query_many_slices": (lambda: _inputs(1, 300_000, 3, seed=21), 16),
    "S_not_multiple_k33": (lambda: _inputs(100, 150_000, 3, seed=22), 33),
    "k128_many_blocks": (lambda: _inputs(300, 150_000, 3, seed=23), 128),
    "d1": (lambda: _inputs(64, 100_000, 1, seed=24), 16),
    "d8": (lambda: _inputs(64, 100_000, 8, seed=25), 16),
    "d11_generic": (lambda: _inputs(40, 30_000, 11, seed=26), 9),
    "pads_fewer_than_k_big": (lambda: _with_pads(70, 120_000, 3), 16),
    "one_slice": (lambda: _inputs(5000, 2000, 3, seed=27), 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_matches_plain(cuda_device, name):
    make, k = CARD_CASES[name]
    q, r = make()
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    before = tkp.knn_pallas.launches
    ki, kv = tkp.knn_pallas(qt, rt, k)
    torch.cuda.synchronize()
    assert tkp.knn_pallas.launches == before + 1
    pi, pv = tkp.knn_tiled_reference(qt, rt, k)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
