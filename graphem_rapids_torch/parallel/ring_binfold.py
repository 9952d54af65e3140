"""Ring bin-fold kNN over the ranks of a mesh (K3).

Counterpart of ``graphem_rapids_tpu/parallel/ring_binfold.py``. The queries
(sampled edge midpoints) are replicated; each rank owns one reference tile.
The queries are cut into ndev shards of S_loc rows, and at hop h rank i folds
shard (i - h) % ndev against its own tile into per-bin running minima, the
bin layout of ops/knn_binfold.py (bin of local position p:
((p // T) % G) * 128 + p % 128, global id rank * R_pad + p). Between hops the
(S_loc, G*128) carry of minima moves one rank to the right. After ndev hops
rank i holds the fully merged bins of shard (i + 1) % ndev; a local
``torch.topk`` and one all_gather (values and ids together) with a row
reorder give every rank the same (S, kk) neighbour set.

Each hop is one launch of the CUDA kernel ``csrc/ring_binfold.cu``
(``ring_fold_cuda``): the fold of the local tile and the min-merge with the
incoming carry, where the carry wins ties. The fold runs the bin fold's
work plan (``csrc/fold_plan.cuh``, shared with K1): a grid of the resident
block count, each block an equal range of (bin group, query block,
super-tile) units, pieces of a cut run folded by the block that completes
their segment, whose thread of a bin then merges the carry there. The plan's
scratch is allocated once per ring call (``ring_fold_scratch``) and reused
by every hop, which run in order on one stream. The carry travels between
launches by one ``batch_isend_irecv`` per hop (NCCL point-to-point on the
card, gloo in the CPU tests) into the other slot of a double buffer; from
the second hop on each hop merges in place. The TPU kernel overlapped that
transfer with the next hop's fold by in-kernel remote copies; here the
fold waits for the transfer, and overlapping them is later work.

``ring_fold_reference`` is the plain PyTorch version of one hop; ``ring_fold``
runs it for CPU tensors and launches the kernel for CUDA tensors.
``ring_fold_pieces_reference`` is the plain model of the kernel's plan
(the hop from the plan's pieces), for the CPU tests.
``ring_binfold_topk_virtual`` runs the same hops for ndev tiles held in one
process, handing the carry over in memory: the plain counterpart of the
whole ring, with which the tests and the smoke run hold the ring.
"""

import ctypes

import torch

from .. import _build
from ..ops.knn_binfold import (
    _BIG,
    _LANES,
    _PAD_COORD,
    MAX_DIM,
    binfold_bins_reference,
    binfold_pieces_reference,
    fold_scratch,
    kernel_blocks_per_sm,
    params_for,
)

__all__ = [
    "REF_LIMIT",
    "ring_binfold_topk",
    "ring_binfold_topk_virtual",
    "ring_fold",
    "ring_fold_cuda",
    "ring_fold_pieces_reference",
    "ring_fold_reference",
    "ring_fold_scratch",
    "ring_supported",
]

# Global id bound (ndev * R_pad): the TPU carries ids in fp32 lanes, exact
# below 2^24. Ids are int32 here; the bound is kept so that the geometry,
# and the tier-down to knn_comm='ring', match the JAX package's.
REF_LIMIT = 1 << 24
# The TPU's VMEM/HBM carry split, kept so that _geometry refuses what JAX's
# refuses; the CUDA kernel keeps the carry in device memory either way.
_VMEM_BUDGET = 10 * 1024 * 1024
_HBM_CARRY_BUDGET = 2 * 1024 * 1024 * 1024


def _geometry(E_loc, S, ndev, k, recall_target):
    """(T, G, n_super, R_pad, S_pad, S_loc, hbm); raises ValueError when the
    geometry exceeds the id bound or the carry budget. ``hbm`` (the TPU's
    choice of carry kernel) is unused here."""
    T, G = params_for(k, recall_target)
    n_tiles = -(-max(E_loc, 1) // T)
    G = min(G, n_tiles)
    n_super = -(-n_tiles // G)
    R_pad = n_super * G * T
    if S % ndev != 0:
        S_pad = -(-S // ndev) * ndev
    else:
        S_pad = S
    S_loc = S_pad // ndev
    S_loc = -(-max(S_loc, 8) // 8) * 8
    S_pad = S_loc * ndev
    if ndev * R_pad > REF_LIMIT:
        raise ValueError(
            f"ring_binfold index lanes: ndev*R_pad = {ndev * R_pad} "
            f"exceeds {REF_LIMIT}; use knn_comm='ring' (the lax.ppermute "
            f"ring has no index-lane bound)"
        )
    resident = 6 * S_loc * G * 128 * 4
    hbm = resident > _VMEM_BUDGET
    if hbm and 4 * S_loc * G * 128 * 4 > _HBM_CARRY_BUDGET:
        raise ValueError(
            f"ring_binfold HBM carry too large: "
            f"{4 * S_loc * G * 128 * 4} bytes (S_loc={S_loc}, G={G}); "
            f"use knn_comm='ring'"
        )
    return T, G, n_super, R_pad, S_pad, S_loc, hbm


def ring_supported(E_loc, S, ndev, k, recall_target=0.95):
    """True when the static geometry fits the ring's bounds."""
    try:
        _geometry(E_loc, S, ndev, k, recall_target)
        return True
    except ValueError:
        return False


def _merge(vals, idx, carry, offset):
    """The hop's epilogue on folded bins (vals, local p): ids offset + p
    where the value is below 3.0e38 (0 elsewhere), then the carry kept
    unless the bin is strictly below it."""
    idx = torch.where(vals < _BIG, idx + int(offset), torch.zeros_like(idx))
    if carry is None:
        return vals, idx
    take = vals < carry[0]
    return torch.where(take, vals, carry[0]), torch.where(take, idx, carry[1])


def ring_fold_reference(q_shard, refs, carry, offset, T, G, n_super):
    """Plain PyTorch hop: (vals (S, G*128) f32, ids (S, G*128) int32).

    Folds ``refs`` into bins as binfold_bins_reference does, with ids
    ``offset + p`` (a bin that keeps (3.0e38, 0) keeps id 0), then merges
    with ``carry`` = (vals, ids), keeping the bin only where it is strictly
    below the carry. ``carry=None`` merges with (3.0e38, 0).
    """
    vals, idx = binfold_bins_reference(q_shard, refs, T, G, n_super)
    return _merge(vals, idx, carry, offset)


def ring_fold_pieces_reference(q_shard, refs, carry, offset, T, G, n_super,
                               n_blocks):
    """Plain model of the kernel's plan for one hop, on a grid of
    ``n_blocks`` blocks: the bins from the plan's pieces
    (binfold_pieces_reference, keys on the local p), then the epilogue of
    ring_fold_reference. Equal to ring_fold_reference bit for bit."""
    vals, idx = binfold_pieces_reference(q_shard, refs, T, G, n_super,
                                         n_blocks)
    return _merge(vals, idx, carry, offset)


def _kernel_fn():
    fn = _build.load("ring_binfold").graphem_ring_fold_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def _blocks_per_sm(device, dim):
    """Resident blocks per SM of the ring kernel for ``dim``."""
    return kernel_blocks_per_sm("ring_binfold",
                                "graphem_ring_fold_blocks_per_sm", device, dim)


def ring_fold_scratch(S, dim, G, n_super, device):
    """The plan's grid and scratch for hops of S queries of ``dim``
    coordinates on ``device``: ((S, dim, G, n_super, device), then
    ``fold_scratch``'s tuple with the ring kernel's occupancy). One scratch
    serves every hop of a ring call, as long as the hops run in order on
    one stream."""
    return ((S, dim, G, n_super, device),) + fold_scratch(
        S, dim, G, n_super, device, _blocks_per_sm(device, dim))


def _check_bins(name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {shape} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def ring_fold_cuda(q_shard, refs, carry, offset, T, G, n_super, out=None,
                   scratch=None):
    """Launch one hop of the CUDA ring kernel; same result as
    ring_fold_reference. ``out`` = (vals, ids) receives the result and may
    be ``carry`` itself (the merge then runs in place). ``scratch`` is
    ``ring_fold_scratch``'s for this shape, or None to allocate it here."""
    S, dim = q_shard.shape
    E = refs.shape[0]
    dev = q_shard.device
    if not q_shard.is_cuda or refs.device != dev:
        raise ValueError("q_shard and refs must be on the same CUDA device")
    if q_shard.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("the ring kernel takes float32 queries and refs")
    if not (1 <= dim <= MAX_DIM) or refs.shape[1] != dim:
        raise ValueError(f"ring kernel takes 1..{MAX_DIM} dims, got {dim}")
    if T % _LANES:
        raise ValueError(f"T must be a multiple of {_LANES}, got {T}")
    if offset < 0 or offset + n_super * G * T >= 2**31:
        raise ValueError("ring kernel ids are int32: offset + R_pad too large")
    if E > n_super * G * T:
        raise ValueError(f"{E} refs exceed the {n_super} x {G} x {T} tiles")
    shape = (S, G * _LANES)
    if carry is not None:
        _check_bins("carry values", carry[0], torch.float32, shape, dev)
        _check_bins("carry ids", carry[1], torch.int32, shape, dev)
    if out is None:
        out = (torch.empty(shape, dtype=torch.float32, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev))
    _check_bins("out values", out[0], torch.float32, shape, dev)
    _check_bins("out ids", out[1], torch.int32, shape, dev)
    if S == 0:
        return out
    if scratch is None:
        scratch = ring_fold_scratch(S, dim, G, n_super, dev)
    made_for, n_blocks, part_v, part_i, seg_done = scratch
    if made_for != (S, dim, G, n_super, dev):
        raise ValueError(f"scratch made for (S, dim, G, n_super, device) = "
                         f"{made_for}, the hop is {(S, dim, G, n_super, dev)}")
    q_shard = q_shard.contiguous()
    refs = refs.contiguous()
    cv = carry[0].data_ptr() if carry is not None else None
    ci = carry[1].data_ptr() if carry is not None else None
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ring_fold.launches += 1
        rc = fn(q_shard.data_ptr(), refs.data_ptr(), cv, ci,
                out[0].data_ptr(), out[1].data_ptr(), part_v.data_ptr(),
                part_i.data_ptr(), seg_done.data_ptr(), S, E, dim, T, G,
                n_super, int(offset), n_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"ring_binfold kernel launch failed: CUDA error {rc}")
    return out


def ring_fold(q_shard, refs, carry, offset, T, G, n_super, out=None,
              scratch=None):
    """One ring hop: the kernel for CUDA tensors, the plain version for CPU
    tensors (which needs no ``scratch``). ``ring_fold.launches`` counts
    kernel launches on the card."""
    if q_shard.is_cuda:
        return ring_fold_cuda(q_shard, refs, carry, offset, T, G, n_super,
                              out=out, scratch=scratch)
    vals, idx = ring_fold_reference(q_shard, refs, carry, offset, T, G,
                                    n_super)
    if out is None:
        return vals, idx
    out[0].copy_(vals)
    out[1].copy_(idx)
    return out


ring_fold.launches = 0


def _padded_queries(q, S_pad):
    """float32 queries with rows S..S_pad-1 at the pad coordinate."""
    q = q.to(torch.float32)
    S, dim = q.shape
    if S_pad == S:
        return q.contiguous()
    pad = torch.full((S_pad - S, dim), _PAD_COORD, dtype=torch.float32,
                     device=q.device)
    return torch.cat([q, pad])


def _top_bins(vals, idx, kk):
    """Top-kk (values, ids) over the merged bins of one shard."""
    if kk > vals.shape[1]:
        raise ValueError(
            f"ring_binfold keeps one candidate per bin: kk={kk} exceeds the "
            f"{vals.shape[1]} bins"
        )
    top, pos = torch.topk(vals, kk, dim=1, largest=False, sorted=True)
    return top, torch.gather(idx, 1, pos)


def ring_binfold_topk(q_mid, mid_loc, kk, *, mesh, recall_target=0.95):
    """Global approximate top-kk over every rank's ref tile, by the ring.

    Call on every rank of ``mesh`` with the same ``q_mid`` (S, d) and the
    rank's own tile ``mid_loc`` (E_loc, d), of equal length on every rank
    (the engine's 1e30 pad rows fold harmlessly). Returns
    (vals (S, kk) f32, ids (S, kk) int32, R_pad), the same on every rank,
    where an id is ``folder_rank * R_pad + local_position``.
    """
    ndev = mesh.world_size
    S_in = q_mid.shape[0]
    E_loc = mid_loc.shape[0]
    T, G, n_super, R_pad, S_pad, S_loc, _ = _geometry(
        E_loc, S_in, ndev, kk, recall_target
    )
    q = _padded_queries(q_mid, S_pad)
    refs = mid_loc.to(torch.float32).contiguous()
    i = mesh.rank
    shape = (S_loc, G * _LANES)
    scratch = (ring_fold_scratch(S_loc, q.shape[1], G, n_super, q.device)
               if q.is_cuda else None)
    slots = [
        (torch.empty(shape, dtype=torch.float32, device=q.device),
         torch.empty(shape, dtype=torch.int32, device=q.device))
        for _ in range(min(ndev, 2))
    ]
    carry = None
    for h in range(ndev):
        s = (i - h) % ndev
        slot = slots[h % 2]
        ring_fold(q[s * S_loc:(s + 1) * S_loc], refs, carry, i * R_pad, T, G,
                  n_super, out=slot, scratch=scratch)
        if h < ndev - 1:
            # the merged carry goes right; the next shard's comes from the
            # left into the other slot, whose previous send was waited on
            carry = slots[(h + 1) % 2]
            works = mesh.send_recv(list(slot), list(carry),
                                   dst=(i + 1) % ndev, src=(i - 1) % ndev)
            for w in works:
                w.wait()
    vals_loc, idx_loc = _top_bins(*slots[(ndev - 1) % 2], kk)
    # one collective for both: the values travel bit-cast to int32 beside
    # the ids, (ndev, S_loc, 2 * kk)
    both = mesh.all_gather(torch.cat([vals_loc.view(torch.int32), idx_loc],
                                     dim=1))
    # shard a ended on rank (a - 1) % ndev: a roll, not an index list, which
    # would cost a host-to-device copy and a sync per call
    both = torch.roll(both, 1, dims=0).reshape(S_pad, 2 * kk)[:S_in]
    vals = both[:, :kk].contiguous().view(torch.float32)
    return vals, both[:, kk:], R_pad


def ring_binfold_topk_virtual(q, tiles, kk, recall_target=0.95, fold=None):
    """``ring_binfold_topk`` for ``len(tiles)`` virtual ranks in one process.

    ``tiles[r]`` is rank r's ref tile; all have the same length. Shard s
    meets the tiles in the ring's order, r = s, s+1, ..., through the same
    hops (ndev^2 of them), its carry handed over in memory. Each hop is
    ``fold(q_shard, tile, carry, offset, T, G, n_super)``: by default
    ``ring_fold``, with one scratch for every hop on the card;
    ``ring_fold_reference`` runs the plain version on any device. Returns
    (vals (S, kk), ids (S, kk) int32, R_pad).
    """
    ndev = len(tiles)
    E_loc = tiles[0].shape[0]
    if any(t.shape[0] != E_loc for t in tiles):
        raise ValueError("every virtual rank's tile must have the same length")
    S_in = q.shape[0]
    T, G, n_super, R_pad, S_pad, S_loc, _ = _geometry(
        E_loc, S_in, ndev, kk, recall_target
    )
    qp = _padded_queries(q, S_pad)
    tiles = [t.to(torch.float32).contiguous() for t in tiles]
    if fold is None:
        scratch = (ring_fold_scratch(S_loc, qp.shape[1], G, n_super,
                                     qp.device) if qp.is_cuda else None)

        def fold(*hop):
            return ring_fold(*hop, scratch=scratch)
    vals, idx = [], []
    for s in range(ndev):
        carry = None
        for h in range(ndev):
            r = (s + h) % ndev
            carry = fold(qp[s * S_loc:(s + 1) * S_loc], tiles[r], carry,
                         r * R_pad, T, G, n_super)
        v, ix = _top_bins(*carry, kk)
        vals.append(v)
        idx.append(ix)
    return (torch.cat(vals)[:S_in], torch.cat(idx)[:S_in], R_pad)
