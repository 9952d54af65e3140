"""The port's ring bin-fold kNN (K3) against the JAX package's.

On the CPU, ``ring_fold`` runs the kernel's plain PyTorch version
(``ring_fold_reference``) and ``ring_binfold_topk_virtual`` runs the ring's
hops for several virtual ranks in one process. They are held against a
numpy model of the bin semantics (tests/test_ring_binfold.py), exactly, and
against JAX ``ring_binfold_topk`` under ``shard_map`` on the CPU mesh, whose
Pallas kernel runs in interpret mode there: the same neighbour sets on
tie-free inputs made with numpy, and distances at rtol=1e-6 (the JAX
interpreter may round the last bit of the coordinate sum differently). The
plain model of the kernel's work plan (``ring_fold_pieces_reference``) is
held against the plain hop bit for bit, and through the virtual ring
against JAX. The CUDA kernel itself
is compared with the plain version, bit for bit, by the tests marked
``cuda``, which need a card; the card's machine has no JAX, so they run
there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_ring_binfold.py
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from graphem_rapids_torch.ops import knn_binfold as tbf
from graphem_rapids_torch.parallel import ring_binfold as trb

RING_CASES = [(8, 64, 8 * 2048, 9), (4, 50, 4 * 2048, 6), (1, 16, 2048, 5)]


def _bin_model_truth(q, refs, k, ndev, R_pad, T, G):
    """Numpy model of the ring's bins (tests/test_ring_binfold.py): global
    id dev*R_pad + p, bin ((p // T) % G)*128 + p % 128 on local p."""
    S = len(q)
    E = len(refs)
    E_loc = E // ndev
    d2 = ((q[:, None, :] - refs[None, :, :]) ** 2).sum(-1)
    dev = np.arange(E) // E_loc
    p = np.arange(E) % E_loc
    bins = ((p // T) % G) * 128 + (p % 128)
    gid = dev * R_pad + p
    nb = G * 128
    bv = np.full((S, nb), np.inf, np.float32)
    bi = np.zeros((S, nb), np.int64)
    for b in range(nb):
        cols = np.flatnonzero(bins == b)
        if len(cols):
            j = cols[np.argmin(d2[:, cols], axis=1)]
            bv[:, b] = d2[np.arange(S), j]
            bi[:, b] = gid[j]
    order = np.argsort(bv, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(bi, order, axis=1)


def _inputs(S, E, dim=3, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, dim)).astype(np.float32)
    refs = rng.standard_normal((E, dim)).astype(np.float32)
    return q, refs


def _virtual(q, refs, ndev, k):
    tiles = list(torch.from_numpy(refs).chunk(ndev))
    return trb.ring_binfold_topk_virtual(torch.from_numpy(q), tiles, k)


@pytest.mark.fast
def test_geometry_matches_jax():
    jrb = pytest.importorskip("graphem_rapids_tpu.parallel.ring_binfold")
    grid = itertools.product(
        (1, 2047, 2048, 5000, 100_000, 1_000_000, 3_000_000, 5_699_741),
        (1, 50, 64, 500, 512, 8192, 100_000),      # S
        (1, 2, 3, 4, 8),                           # ndev
        (1, 6, 9, 16, 48),                         # k
        (0.9, 0.95),
    )
    refused = {"index": 0, "carry": 0}
    for E_loc, S, ndev, k, recall in grid:
        try:
            want = jrb._geometry(E_loc, S, ndev, k, recall)
        except ValueError as e:
            refused["index" if "index" in str(e) else "carry"] += 1
            with pytest.raises(ValueError, match=str(e)[:20]):
                trb._geometry(E_loc, S, ndev, k, recall)
            assert not trb.ring_supported(E_loc, S, ndev, k, recall)
            continue
        assert trb._geometry(E_loc, S, ndev, k, recall) == want
        assert trb.ring_supported(E_loc, S, ndev, k, recall)
    assert refused["index"] > 0 and refused["carry"] > 0
    assert trb.REF_LIMIT == jrb.REF_LIMIT


@pytest.mark.fast
@pytest.mark.parametrize("offset", [0, 3 * 4096])
def test_fold_without_carry_is_binfold_offset(offset):
    q, r = _inputs(24, 3000, dim=2, seed=4)
    r[::29] = 1e30  # non-edge slots: +inf, never taken
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    T, G, n_super = 128, 4, 6
    before = trb.ring_fold.launches
    vals, idx = trb.ring_fold(qt, rt, None, offset, T, G, n_super)
    assert trb.ring_fold.launches == before  # the CPU runs no kernel
    bv, bi = tbf.binfold_bins_reference(qt, rt, T, G, n_super)
    assert torch.equal(vals, bv)
    kept = bv < tbf._BIG
    assert torch.equal(idx, torch.where(kept, bi + offset, 0))
    assert idx.dtype == torch.int32 and vals.shape == (24, G * 128)


@pytest.mark.fast
def test_merge_keeps_carry_on_ties_and_aliases():
    """bins < carry takes the tile's bin; a tie keeps the carry; the
    output may be the carry itself."""
    T, G, n_super = 128, 1, 1
    q = torch.zeros((2, 2))
    refs = torch.full((128, 2), 1e30)
    refs[3] = torch.tensor([1.0, 0.0])    # bin 3: distance 1
    refs[7] = torch.tensor([0.0, 2.0])    # bin 7: distance 4
    carry = (torch.full((2, 128), tbf._BIG),
             torch.zeros((2, 128), dtype=torch.int32))
    carry[0][:, 3] = 1.0       # tie: the carry's id 99 stays
    carry[1][:, 3] = 99
    carry[0][:, 7] = 5.0       # the tile's 4 < 5: id 500 + 7
    carry[1][:, 7] = 77
    carry[0][:, 9] = 0.5       # the tile only sees +inf here
    carry[1][:, 9] = 55
    out = trb.ring_fold(q, refs, carry, 500, T, G, n_super, out=carry)
    assert out is carry
    assert out[1][0, 3] == 99 and out[0][0, 3] == 1.0
    assert out[1][0, 7] == 507 and out[0][0, 7] == 4.0
    assert out[1][0, 9] == 55 and out[0][0, 9] == 0.5
    assert out[1][0, 0] == 0 and out[0][0, 0] == tbf._BIG


@pytest.mark.fast
@pytest.mark.parametrize("ndev,S,E,k", RING_CASES)
def test_virtual_ring_matches_bin_model(ndev, S, E, k):
    q, refs = _inputs(S, E)
    vals, idx, R_pad = _virtual(q, refs, ndev, k)
    T, G, _, R_pad_g, _, _, _ = trb._geometry(E // ndev, S, ndev, k, 0.95)
    assert R_pad == R_pad_g and idx.shape == (S, k)
    gt = _bin_model_truth(q, refs, k, ndev, R_pad, T, G)
    np.testing.assert_array_equal(idx.numpy(), gt)
    # the distances are those of the chosen refs
    loc = (idx.numpy() // R_pad) * (E // ndev) + idx.numpy() % R_pad
    d2 = ((q[:, None, :] - refs[loc]) ** 2).sum(-1)
    np.testing.assert_allclose(vals.numpy(), d2, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_ring(ndev, S, E, k):
    """JAX ``ring_binfold_topk`` under ``shard_map`` on the CPU mesh (its
    Pallas kernel in interpret mode): numpy (vals, ids)."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from graphem_rapids_tpu.parallel.ring_binfold import ring_binfold_topk

    axis, dim = "x", 3
    q, refs = _inputs(S, E, dim)
    E_loc = E // ndev
    mesh = Mesh(np.array(jax.devices()[:ndev]), (axis,))

    def body(q_all, refs_all):
        i = jax.lax.axis_index(axis)
        r = jax.lax.dynamic_slice(refs_all, (i * E_loc, 0), (E_loc, dim))
        v, ix, _ = ring_binfold_topk(q_all, r, k, ndev=ndev, axis_name=axis)
        return v, ix

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                               out_specs=(P(), P()), check_vma=False))
    jv, ji = fn(q, refs)
    return np.asarray(jv), np.asarray(ji)


@pytest.mark.fast
@pytest.mark.parametrize("ndev,S,E,k", RING_CASES)
def test_virtual_ring_matches_jax_ring(ndev, S, E, k):
    jv, ji = _jax_ring(ndev, S, E, k)
    q, refs = _inputs(S, E)
    vals, idx, _ = _virtual(q, refs, ndev, k)
    np.testing.assert_array_equal(np.sort(idx.numpy(), axis=1),
                                  np.sort(ji, axis=1))
    # the JAX interpreter may round the per-coordinate sum differently in
    # the last bit (as in tests/test_torch_binfold.py)
    np.testing.assert_allclose(vals.numpy(), jv, rtol=1e-6)


@pytest.mark.fast
@pytest.mark.parametrize("ndev,S,E,k", RING_CASES)
def test_virtual_ring_of_pieces_matches_jax_ring(ndev, S, E, k):
    """Every hop by the plain model of the kernel's plan (on 3 blocks):
    JAX's neighbour sets and distances."""
    jv, ji = _jax_ring(ndev, S, E, k)
    q, refs = _inputs(S, E)
    tiles = list(torch.from_numpy(refs).chunk(ndev))
    vals, idx, _ = trb.ring_binfold_topk_virtual(
        torch.from_numpy(q), tiles, k,
        fold=functools.partial(trb.ring_fold_pieces_reference, n_blocks=3))
    np.testing.assert_array_equal(np.sort(idx.numpy(), axis=1),
                                  np.sort(ji, axis=1))
    np.testing.assert_allclose(vals.numpy(), jv, rtol=1e-6)


def _periodic(S, E, d, T, G, seed):
    """Refs repeating every G*T positions: each bin sees the same value in
    every super-tile, so every piece boundary cuts through exact ties."""
    q, r = _inputs(S, G * T, d, seed)
    return q, np.resize(r, (E, d))


# name: (S, E, d, T, G, n_blocks, offset, carry); carry "other" is the fold
# of another tile, "same" the fold of this tile (every bin ties with it)
PIECE_HOPS = {
    "ragged_E_and_S": (21, 9001, 3, 256, 4, 5, 3 * 9216, "other"),
    "blocks_above_units": (7, 1000, 2, 128, 24, 40, 1024, "other"),
    "d1": (9, 3000, 1, 128, 2, 40, 7 * 3072, "other"),
    "d8": (13, 2000, 8, 128, 3, 4, 2048, "other"),
    "all_pad_bins": (16, 1536, 3, 128, 4, 6, 5 * 1536, None),
    "ties_across_pieces_and_carry": (20, 14 * 384, 3, 128, 3, 7, 5376,
                                     "same"),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(PIECE_HOPS))
def test_pieces_hop_equals_reference(name):
    """The hop from the plan's pieces (keys on the local p, then the
    offset and the carry merge) equals ring_fold_reference bit for bit:
    ragged E and S, more blocks than units, d=1 and 8, offset != 0,
    all-pad bins keeping (3.0e38, 0), ties across piece boundaries and
    against the carry (the carry wins)."""
    S, E, d, T, G, n_blocks, offset, carry_kind = PIECE_HOPS[name]
    if name == "ties_across_pieces_and_carry":
        q, r = _periodic(S, E, d, T, G, seed=6)
    else:
        q, r = _inputs(S, E, d, seed=8)
    r = r.copy()
    period = G * T if name == "ties_across_pieces_and_carry" else E
    r[np.arange(E) % period % 7 == 0] = 1e30  # +inf in some pieces
    if name == "all_pad_bins":
        r[:] = 1e30
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    G_eff, n_super = tbf._geometry(E, T, G)
    carry = None
    if carry_kind == "other":
        carry = trb.ring_fold_reference(qt, rt.flip(0).contiguous() * 0.5,
                                        None, 0, T, G_eff, n_super)
    elif carry_kind == "same":
        carry = trb.ring_fold_reference(qt, rt, None, 0, T, G_eff, n_super)
    pv, pi = trb.ring_fold_reference(qt, rt, carry, offset, T, G_eff,
                                     n_super)
    kv, ki = trb.ring_fold_pieces_reference(qt, rt, carry, offset, T, G_eff,
                                            n_super, n_blocks)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    _, _, units, _ = tbf.fold_plan(S, G_eff, n_super, 1, d, 1)
    if name == "blocks_above_units":
        assert n_blocks > units
    if name == "all_pad_bins":
        assert (pv == 3.0e38).all() and (pi == 0).all()
    if name == "ties_across_pieces_and_carry":
        assert torch.equal(kv, carry[0]) and torch.equal(ki, carry[1])
        assert (ki < G_eff * T).all()  # the first super-tile's p, offset 0
    if carry_kind == "other":  # both the tile and the carry win some bins
        took = ki >= offset
        assert took.any() and not took.all()


@pytest.mark.fast
def test_one_rank_ring_is_binfold_knn():
    """One rank, no process group: the ring's answer is knn_binfold's."""
    from graphem_rapids_torch.parallel import make_mesh

    q, refs = _inputs(40, 9000, seed=5)
    qt, rt = torch.from_numpy(q), torch.from_numpy(refs)
    vals, idx, R_pad = trb.ring_binfold_topk(qt, rt, 9,
                                             mesh=make_mesh(device="cpu"))
    bi, bv = tbf.knn_binfold(qt, rt, 9)
    assert R_pad >= 9000
    assert torch.equal(idx, bi) and torch.equal(vals, bv)


@pytest.mark.fast
def test_query_pad_rows_dropped():
    """S=13 pads to 8-row shards at the pad coordinate; only real rows
    return, and they match the unpadded single-rank answer."""
    q, refs = _inputs(13, 4 * 2048, seed=6)
    vals, idx, _ = _virtual(q, refs, 4, 5)
    assert idx.shape == (13, 5) and torch.isfinite(vals).all()
    assert (vals < 1e20).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,E,d,T,G,offset,carry", [
    (128, 1_424_936, 3, 2048, 24, 2 * 1_425_408, True),
    (64, 20_077, 4, 2048, 24, 0, False),
    (50, 9001, 2, 2048, 24, 7 * 10_240, True),
    (7, 9001, 2, 2048, 24, 10_240, True),     # fewer units than blocks
    (37, 300_001, 1, 2048, 24, 300_032, True),  # d=1, ragged pieces
    (45, 100_000, 8, 2048, 24, 3 * 100_352, True),  # d=8, 8 queries a block
])
def test_kernel_matches_plain(cuda_device, S, E, d, T, G, offset, carry):
    q, r = _inputs(S, E, d, seed=2)
    r[::37] = 1e30
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(E, T, G)
    c = None
    if carry:
        c = trb.ring_fold_reference(qt, rt.flip(0).contiguous(), None, 0, T,
                                    G_eff, n_super)
    before = trb.ring_fold.launches
    kv, ki = trb.ring_fold_cuda(qt, rt, c, offset, T, G_eff, n_super)
    torch.cuda.synchronize()
    assert trb.ring_fold.launches == before + 1
    pv, pi = trb.ring_fold_reference(qt, rt, c, offset, T, G_eff, n_super)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    if c is not None:  # in place on the carry
        out = trb.ring_fold_cuda(qt, rt, c, offset, T, G_eff, n_super, out=c)
        torch.cuda.synchronize()
        assert torch.equal(out[0], pv) and torch.equal(out[1], pi)


@pytest.mark.cuda
def test_kernel_ties_across_pieces_and_carry_in_place(cuda_device):
    """Refs repeating every G*T positions at the 1M shape's super-tile
    count, on 64 queries, and a carry folded from the same tile: every bin
    ties in all 116 super-tiles and with the carry. In place, the carry
    must come out unchanged."""
    T, G = 2048, 24
    q, r = _periodic(64, 5_699_741, 3, T, G, seed=12)
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(len(r), T, G)
    R_pad = n_super * G_eff * T
    first = trb.ring_fold_cuda(qt, rt, None, 0, T, G_eff, n_super)
    torch.cuda.synchronize()
    pv, pi = trb.ring_fold_reference(qt, rt[:G_eff * T], None, 0, T, G_eff, 1)
    assert torch.equal(first[0], pv) and torch.equal(first[1], pi)
    carry = (first[0].clone(), first[1].clone())
    out = trb.ring_fold_cuda(qt, rt, carry, R_pad, T, G_eff, n_super,
                             out=carry)
    torch.cuda.synchronize()
    assert torch.equal(out[0], pv) and torch.equal(out[1], pi)


@pytest.mark.cuda
def test_kernel_scratch_reused_and_checked(cuda_device):
    """One scratch serves two hops of its shape (in place on the carry, as
    the ring runs them); a scratch made for another shape is refused."""
    T, G = 2048, 24
    q, r = _inputs(50, 30_000, 3, seed=9)
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(len(r), T, G)
    scratch = trb.ring_fold_scratch(50, 3, G_eff, n_super, qt.device)
    carry = trb.ring_fold_cuda(qt, rt, None, 0, T, G_eff, n_super,
                               scratch=scratch)
    pv, pi = trb.ring_fold_reference(qt, rt, None, 0, T, G_eff, n_super)
    flip = rt.flip(0).contiguous()
    pv, pi = trb.ring_fold_reference(qt, flip, (pv, pi), 10**6, T, G_eff,
                                     n_super)
    out = trb.ring_fold_cuda(qt, flip, carry, 10**6, T, G_eff, n_super,
                             out=carry, scratch=scratch)
    torch.cuda.synchronize()
    assert torch.equal(out[0], pv) and torch.equal(out[1], pi)
    other = trb.ring_fold_scratch(40, 3, G_eff, n_super, qt.device)
    before = trb.ring_fold.launches
    with pytest.raises(ValueError, match="scratch made for"):
        trb.ring_fold_cuda(qt, rt, None, 0, T, G_eff, n_super, scratch=other)
    assert trb.ring_fold.launches == before


@pytest.mark.cuda
def test_virtual_ring_kernel_matches_plain(cuda_device):
    q, refs = _inputs(500, 4 * 3000, seed=3)
    tiles = [t.to(cuda_device) for t in torch.from_numpy(refs).chunk(4)]
    qc = torch.from_numpy(q).to(cuda_device)
    kv, ki, _ = trb.ring_binfold_topk_virtual(qc, tiles, 16)
    pv, pi, _ = trb.ring_binfold_topk_virtual(
        torch.from_numpy(q), [t.cpu() for t in tiles], 16)
    assert torch.equal(kv.cpu(), pv)
    assert torch.equal(torch.sort(ki.cpu(), dim=1).values,
                       torch.sort(pi, dim=1).values)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = trb.ring_fold.launches
    with pytest.raises(ValueError, match="CUDA"):
        trb.ring_fold_cuda(torch.zeros((8, 3)), torch.zeros((300, 3)), None,
                           0, 128, 2, 2)
    assert trb.ring_fold.launches == before
