"""The bin-fold kNN of the PyTorch port against the JAX Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version
(binfold_bins_reference); the JAX kernel runs in Pallas interpret mode,
which knn_binfold selects by itself off a TPU. Inputs are tie-free random
floats made with numpy, so indices must be equal; values are held at
rtol=1e-6 (the JAX interpreter may round the per-coordinate sum
differently in the last bit). The CUDA kernel itself is compared with the
plain version, bit for bit, by the tests marked ``cuda``, which need a card.
The card's machine has no JAX, so the JAX package is imported inside the
tests that use it, and the card tests run there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_binfold.py
"""

import numpy as np
import pytest
import torch

from graphem_rapids_torch.ops import knn_binfold as tbf


def _jax():
    """(jax.numpy, the JAX package's knn_binfold module)."""
    jnp = pytest.importorskip("jax.numpy")
    return jnp, pytest.importorskip("graphem_rapids_tpu.ops.knn_binfold")


CASES = [  # tests/test_knn_binfold.py::test_binfold_matches_exact
    (64, 5000, 3, 8, 256, 4),
    (32, 1000, 2, 5, 128, 3),
    (16, 300, 4, 17, 128, 2),
    (64, 9001, 3, 8, 256, 4),
    (7, 500, 3, 4, 128, 2),
]


def _inputs(S, E, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, d)).astype(np.float32) * 10
    r = rng.normal(size=(E, d)).astype(np.float32) * 10
    return q, r


@pytest.mark.fast
@pytest.mark.parametrize("S,E,d,k,T,G", CASES)
def test_plain_matches_jax_kernel(S, E, d, k, T, G):
    jnp, jbf = _jax()
    q, r = _inputs(S, E, d)
    ji, jv = jbf.knn_binfold(jnp.asarray(q), jnp.asarray(r), k, T=T, G=G)
    launches = tbf.knn_binfold.launches
    ti, tv = tbf.knn_binfold(torch.from_numpy(q), torch.from_numpy(r), k,
                             T=T, G=G)
    assert tbf.knn_binfold.launches == launches  # the CPU runs no kernel
    assert ti.dtype == torch.int32 and ti.shape == (S, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.fast
def test_plain_matches_jax_segments():
    jnp, jbf = _jax()
    rng = np.random.default_rng(4)
    S, E, d, k = 16, 2000, 3, 10
    q = rng.standard_normal((S, d)).astype(np.float32)
    r = rng.standard_normal((E, d)).astype(np.float32)
    ji, jv = jbf._binfold_segments(jnp.asarray(q), jnp.asarray(r), k, 128, 4,
                                   S, seg=512, n_seg=4, interpret=True)
    ti, tv = tbf._binfold_segments(torch.from_numpy(q), torch.from_numpy(r),
                                   k, 128, 4, seg=512, n_seg=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.fast
def test_plain_bins_pad_and_tie_rules():
    """A bin that sees only 1e30-padded refs keeps (3e38, 0); the kernel's
    own 1e15 pad past E gives a finite distance and an index >= E; equal
    distances keep the lowest position."""
    T, G = 128, 2
    q = torch.zeros((1, 2))
    refs = torch.full((300, 2), 1e30)
    refs[5] = torch.tensor([1.0, 0.0])
    refs[5 + T * G] = torch.tensor([0.0, 1.0])  # same bin, same distance
    G_eff, n_super = tbf._geometry(300, T, G)
    vals, idx = tbf.binfold_bins_reference(q, refs, T, G_eff, n_super)
    assert (G_eff, n_super) == (2, 2)
    assert vals[0, 5] == 1.0 and idx[0, 5] == 5
    # bin 6 saw refs 6 and 262, both 1e30 (+inf): it keeps the init
    assert vals[0, 6] == 3.0e38 and idx[0, 6] == 0
    # bin 50 saw ref 50 (+inf) and position 306 >= E (the 1e15 pad)
    assert idx[0, 50] == 306 and 1e29 < vals[0, 50] < 1e31
    # bin 200 (group 1, lane 72) saw ref 200 (+inf) and position 456
    assert idx[0, 200] == 456 and 1e29 < vals[0, 200] < 1e31
    assert torch.isinf(vals).sum() == 0
    only_inf = torch.full((T * G, 2), 1e30)
    v2, i2 = tbf.binfold_bins_reference(q, only_inf, T, G, 1)
    assert (v2 == 3.0e38).all() and (i2 == 0).all()


@pytest.mark.fast
def test_params_for_equals_jax():
    _, jbf = _jax()
    for k in (1, 5, 16, 17, 30, 48, 100):
        for recall in (0.3, 0.9, 0.95, 0.99, 0.9999):
            assert tbf.params_for(k, recall) == jbf.params_for(k, recall)
    assert tbf.params_for(16, 0.95, T=1024) == jbf.params_for(16, 0.95, T=1024)
    for name in ("MAX_REFS", "MAX_SEGMENTS", "MAX_REFS_SEGMENTED", "MAX_DIM",
                 "MAX_K", "_PAD_COORD", "_BIG"):
        assert getattr(tbf, name) == getattr(jbf, name), name


@pytest.mark.fast
def test_k_exceeding_bins_raises():
    q = torch.zeros((8, 3))
    r = torch.zeros((300, 3))
    with pytest.raises(ValueError, match="bins"):
        tbf.knn_binfold(q, r, 24 * 128 + 1)


@pytest.mark.fast
def test_max_refs_raises():
    class FakeRefs:
        shape = (tbf.MAX_REFS_SEGMENTED + 1, 3)

    with pytest.raises(ValueError, match="references"):
        tbf.knn_binfold(torch.zeros((8, 3)), FakeRefs(), 5)


@pytest.mark.fast
def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch path never hands host pointers to the kernel."""
    before = tbf.knn_binfold.launches
    with pytest.raises(ValueError, match="CUDA"):
        tbf.binfold_bins_cuda(torch.zeros((4, 3)), torch.zeros((300, 3)),
                              128, 2, 2)
    assert tbf.knn_binfold.launches == before


# fold plans: (S, G, n_super, sm_count, dim, blocks_per_sm)
PLANS = [
    (512, 24, 17, 132, 3, 5),    # the 100K main path: 13,056 units, 660 blocks
    (512, 24, 116, 132, 3, 5),   # the 1M main path
    (416, 24, 116, 132, 3, 5),   # S=416, the wave diagnostic
    (7, 5, 1, 132, 2, 5),        # fewer units than resident blocks
    (33, 3, 1, 4, 3, 2),         # n_super = 1: every piece is one unit
    (100, 7, 9, 3, 8, 4),        # d=8: 8 queries per block
    (17, 2, 13, 1, 1, 1),        # one block takes everything
]


@pytest.mark.fast
@pytest.mark.parametrize("S,G,n_super,sm,dim,bps", PLANS)
def test_fold_plan_covers_units(S, G, n_super, sm, dim, bps):
    """Every (bin group, query, super-tile) is folded by exactly one run,
    and the blocks' ranges are one wave and equal to within one unit."""
    qb, n_qblk, units, n_blocks = tbf.fold_plan(S, G, n_super, sm, dim, bps)
    assert qb == (16 if dim <= 3 else 8) and n_qblk * qb >= S > (n_qblk - 1) * qb
    assert units == G * n_qblk * n_super
    assert n_blocks == min(units, sm * bps)
    sizes = [u1 - u0 for u0, u1 in tbf.fold_ranges(units, n_blocks)]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    seen = np.zeros((G, n_qblk * qb, n_super), dtype=np.int64)
    runs = tbf.fold_runs(units, n_blocks, n_super)
    for b, seg, s0, s1 in runs:
        g, qblk = divmod(seg, n_qblk)
        seen[g, qblk * qb:(qblk + 1) * qb, s0:s1] += 1
    assert (seen == 1).all()
    # a piece is the first or the last run of its block (the kernel's two
    # scratch slots)
    for b in range(n_blocks):
        mine = [(s0, s1) for bb, _, s0, s1 in runs if bb == b]
        assert all(r == (0, n_super) for r in mine[1:-1])


def _periodic(S, E, d, T, G, seed):
    """Refs repeating every G*T positions: each bin sees the same value in
    every super-tile, so every piece boundary cuts through exact ties."""
    q, r = _inputs(S, G * T, d, seed)
    return q, np.resize(r, (E, d))


PIECES = {
    # name: (inputs, T, G, n_blocks)
    "ragged_pieces": (lambda: _inputs(33, 9001, 3, seed=5), 256, 4, 5),
    "ties_across_pieces": (lambda: _periodic(20, 14 * 384, 3, 128, 3, 6), 128, 3,
                           7),
    "n_super_1": (lambda: _inputs(21, 512, 2, seed=7), 128, 8, 3),
    "d1_many_blocks": (lambda: _inputs(9, 3000, 1, seed=8), 128, 2, 40),
    "d8_S_not_multiple": (lambda: _inputs(13, 2000, 8, seed=9), 128, 3, 4),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(PIECES))
def test_pieces_fold_to_reference(name):
    """The plan's pieces, combined by their packed keys, give the bins of
    binfold_bins_reference bit for bit, including all-pad bins (3.0e38, 0)
    and ties that a piece boundary cuts (the lowest p wins)."""
    make, T, G, n_blocks = PIECES[name]
    q, r = make()
    r = r.copy()
    period = G * T if name == "ties_across_pieces" else len(r)
    r[np.arange(len(r)) % period % 7 == 0] = 1e30  # +inf in some pieces
    if name == "n_super_1":
        r[:] = 1e30  # every bin sees only +inf
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    G_eff, n_super = tbf._geometry(len(r), T, G)
    pv, pi = tbf.binfold_bins_reference(qt, rt, T, G_eff, n_super)
    kv, ki = tbf.binfold_pieces_reference(qt, rt, T, G_eff, n_super, n_blocks)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    if name == "n_super_1":
        assert (pv == 3.0e38).all() and (pi == 0).all()
    if name == "ties_across_pieces":
        # every bin's winner lies in the first super-tile
        assert (pi < G_eff * T).all()


@pytest.mark.fast
def test_packed_keys_order_as_value_then_index():
    """int64 keys with the value's bits in the high word sort exactly as
    (value, index) for values >= +0: zero, denormals, ties, 3.0e38, inf."""
    rng = np.random.default_rng(11)
    special = np.array([0.0, 1e-45, 1e-40, 1.17549435e-38, 1.0, 1.0, 3.0e38,
                        np.inf], dtype=np.float32)
    vals = np.concatenate([special, rng.choice(special, 500),
                           np.abs(rng.normal(size=500)).astype(np.float32)])
    idx = rng.integers(0, 2**31 - 1, len(vals)).astype(np.int32)
    idx[:4] = [0, 2**31 - 1, 5, 5]
    keys = tbf.pack_keys(torch.from_numpy(vals), torch.from_numpy(idx))
    assert keys.dtype == torch.int64 and (keys >= 0).all()
    lex = np.lexsort((idx, vals))
    assert np.array_equal(keys.numpy()[lex], np.sort(keys.numpy()))
    back_v, back_i = tbf.unpack_keys(keys)
    assert np.array_equal(back_v.numpy(), vals)
    assert np.array_equal(back_i.numpy(), idx)
    # a piece that took nothing never beats a real value
    empty = tbf.pack_keys(torch.tensor(3.0e38), torch.tensor(0))
    assert (tbf.pack_keys(torch.tensor([2.9e38, 0.0]),
                          torch.tensor([7, 2**31 - 1])) < empty).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bin-fold kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,E,d,T,G", [
    (512, 800_000, 3, 2048, 24),
    (7, 9001, 2, 2048, 24),
    (7, 20_077, 4, 2048, 24),
    (416, 800_000, 3, 2048, 24),   # the wave diagnostic's shape
    (512, 5_699_741, 3, 2048, 24),  # the 1M main path: many waves of units
    (500, 24 * 2048, 3, 2048, 24),  # n_super = 1: every run a piece or whole
    (37, 300_001, 1, 2048, 24),     # d=1, ragged last super-tile
    (45, 100_000, 8, 2048, 24),     # d=8, 8 queries per block
    (3, 7000, 3, 128, 5),           # fewer units than resident blocks
])
def test_kernel_matches_plain(cuda_device, S, E, d, T, G):
    q, r = _inputs(S, E, d, seed=1)
    r[::37] = 1e30  # non-edge ref slots
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(E, T, G)
    before = tbf.knn_binfold.launches
    kv, ki = tbf.binfold_bins_cuda(qt, rt, T, G_eff, n_super)
    torch.cuda.synchronize()
    assert tbf.knn_binfold.launches == before + 1
    for i in range(0, S, 64):  # the plain fold is row by row
        pv, pi = tbf.binfold_bins_reference(qt[i:i + 64], rt, T, G_eff,
                                            n_super)
        assert torch.equal(kv[i:i + 64], pv) and torch.equal(ki[i:i + 64], pi)


@pytest.mark.cuda
def test_kernel_ties_across_pieces(cuda_device):
    """Refs repeating every G*T positions at the 1M shape's super-tile
    count: every bin ties in all 116 super-tiles, and the pieces of the
    plan must keep the first."""
    T, G = 2048, 24
    q, r = _periodic(512, 5_699_741, 3, T, G, seed=12)
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(len(r), T, G)
    kv, ki = tbf.binfold_bins_cuda(qt, rt, T, G_eff, n_super)
    torch.cuda.synchronize()
    assert bool((ki < G_eff * T).all())
    pv, pi = tbf.binfold_bins_reference(qt[:64], rt[:G_eff * T], T, G_eff, 1)
    assert torch.equal(kv[:64], pv) and torch.equal(ki[:64], pi)


@pytest.mark.cuda
@pytest.mark.parametrize("E,max_refs", [(20_000, 4096), (9001, 2048)])
def test_segmented_call_matches_plain(cuda_device, monkeypatch, E, max_refs):
    """Past MAX_REFS (lowered here) knn_binfold launches the kernel once a
    segment, lifts the ids and merges with one top-k: the same pairs as
    the plain fold of each segment with the same merge, and n_seg
    launches."""
    monkeypatch.setattr(tbf, "MAX_REFS", max_refs)
    monkeypatch.setattr(tbf, "MAX_REFS_SEGMENTED", max_refs * 16)
    q, r = _inputs(64, E, 3, seed=5)
    r[::41] = 1e30
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    T = 128
    _, n_seg = tbf.segments(E, T)
    assert n_seg >= 3
    before = tbf.knn_binfold.launches
    ki, kv = tbf.knn_binfold(qt, rt, 16, T=T, G=4)
    torch.cuda.synchronize()
    assert tbf.knn_binfold.launches == before + n_seg
    monkeypatch.setattr(tbf, "binfold_bins", tbf.binfold_bins_reference)
    pi, pv = tbf.knn_binfold(qt, rt, 16, T=T, G=4)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
