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

On the cards the whole ring is one launch of the CUDA kernel
``csrc/ring_binfold.cu`` per call (``ring_run_cuda``), as the TPU's ring is
one ``pallas_call``: every hop folds the local tile (the bin fold's work
plan, ``csrc/fold_plan.cuh``, shared with K1), merges the carry that the
left neighbour's kernel stored into this rank's memory, where the carry wins
ties, and stores the merged carry straight into the right neighbour's slot
over NVLink, with flags for flow control (the kernel's header has the
protocol). Each rank's slots, flags and plan scratch are one ``cudaMalloc``
region (``RingRegion``), allocated once per ring geometry outside any
capture, its IPC handle exchanged once over the process group and the two
neighbours' regions mapped into this process (``ring_region``). Neighbours
need peer access between their cards: ``check_ring_peers`` raises where
they have none. On the CPU (gloo, the tests) each hop is the plain fold and
the carry travels between hops by one ``batch_isend_irecv``.

``ring_fold_cuda`` launches one hop into a caller's buffer (the per-hop
entry of the kernel, for the timing script and the per-hop checks);
``ring_fold.launches`` counts K3's launches by either entry.
``ring_fold_reference`` is the plain PyTorch version of one hop; ``ring_fold``
runs it for CPU tensors and launches the kernel for CUDA tensors.
``ring_fold_pieces_reference`` is the plain model of the kernel's plan
(the hop from the plan's pieces), for the CPU tests.
``ring_binfold_topk_virtual`` runs the same hops for ndev tiles held in one
process, handing the carry over in memory: the plain counterpart of the
whole ring, with which the tests and the smoke run hold the ring.
``ring_binfold_topk_transfer`` runs the same ring on one card through the
kernel's store-and-flag path, the regions of virtual ranks standing in for
the neighbours' cards.
"""

import ctypes
import socket

import torch

from .. import _build
from ..ops.knn_binfold import (
    _BIG,
    _LANES,
    _PAD_COORD,
    MAX_DIM,
    binfold_bins_reference,
    binfold_pieces_reference,
    fold_plan,
    fold_scratch,
    kernel_blocks_per_sm,
    params_for,
)
from ..utils import tracing

__all__ = [
    "REF_LIMIT",
    "RingRegion",
    "check_ring_peers",
    "ring_binfold_topk",
    "ring_binfold_topk_transfer",
    "ring_binfold_topk_virtual",
    "ring_fold",
    "ring_fold_cuda",
    "ring_fold_pieces_reference",
    "ring_fold_reference",
    "ring_fold_scratch",
    "ring_peer_problem",
    "ring_region",
    "ring_run_cuda",
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
tracing.counts_launches(ring_fold)


# ---- the whole ring on the cards ------------------------------------------

def _entry(name, restype, argtypes):
    fn = getattr(_build.load("ring_binfold"), name)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _check_rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"ring_binfold {what} failed: CUDA error {rc}")


def ring_run_grid(S, dim, G, n_super, device, share=1):
    """The whole-ring kernel's grid for shards of S queries: the fold plan's
    one wave of resident blocks (every block must be resident, since blocks
    wait for each other), divided by ``share`` when that many rings run on
    one card at once."""
    per_sm = kernel_blocks_per_sm("ring_binfold",
                                  "graphem_ring_run_blocks_per_sm", device,
                                  dim)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    _, _, units, _ = fold_plan(S, G, n_super, sm_count, dim, per_sm)
    return max(1, min(units, sm_count * per_sm // share))


class RingRegion:
    """One rank's region of the whole-ring kernel: its carry slots, flags,
    counters and plan scratch, one zeroed ``cudaMalloc`` block on
    ``device`` (CUDA IPC maps base allocations only), made for shards of
    ``S`` queries of ``dim`` coordinates, G bin groups and a grid of
    ``n_blocks``. ``right`` and ``left`` are the neighbours' regions as
    mapped here (this region's own pointer until ``open`` maps them)."""

    def __init__(self, S, dim, G, n_super, device, n_blocks):
        self.made_for = (S, dim, G, n_super, torch.device(device), n_blocks)
        self.device = torch.device(device)
        nbytes = _entry("graphem_ring_region_bytes", ctypes.c_longlong,
                        [ctypes.c_int] * 4)(S, G, dim, n_blocks)
        ptr = ctypes.c_void_p()
        alloc = _entry("graphem_ring_region_alloc", ctypes.c_int,
                       [ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p)])
        with torch.cuda.device(self.device):
            _check_rc(alloc(nbytes, ctypes.byref(ptr)), "region allocation")
        self.nbytes = nbytes
        self.base = self.right = self.left = ptr.value
        self._opened = []

    def handle(self):
        """The region's CUDA IPC handle (64 bytes)."""
        buf = ctypes.create_string_buffer(64)
        fn = _entry("graphem_ring_ipc_handle", ctypes.c_int,
                    [ctypes.c_void_p, ctypes.c_void_p])
        with torch.cuda.device(self.device):
            _check_rc(fn(self.base, buf), "IPC handle")
        return buf.raw

    def open(self, handle):
        """Maps another process's region (its ``handle()``) here."""
        ptr = ctypes.c_void_p()
        fn = _entry("graphem_ring_ipc_open", ctypes.c_int,
                    [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)])
        with torch.cuda.device(self.device):
            _check_rc(fn(handle, ctypes.byref(ptr)), "IPC open")
        self._opened.append(ptr.value)
        return ptr.value

    def close(self):
        """Unmaps the neighbours' regions and frees this one."""
        if self.base is None:
            return
        close = _entry("graphem_ring_ipc_close", ctypes.c_int,
                       [ctypes.c_void_p])
        free = _entry("graphem_ring_region_free", ctypes.c_int,
                      [ctypes.c_void_p])
        with torch.cuda.device(self.device):
            for ptr in self._opened:
                close(ptr)
            free(self.base)
        self._opened = []
        self.base = self.right = self.left = None


def ring_peer_problem(where, rank, can_access):
    """Why rank ``rank`` cannot store into its ring neighbours' memory, or
    None. ``where`` is every rank's (host, device), in rank order;
    ``can_access(mine, theirs)`` is torch.cuda.can_device_access_peer on two
    device names. Two ranks on one card need no peer access."""
    world = len(where)
    host, dev = where[rank]
    for r in sorted({(rank - 1) % world, (rank + 1) % world} - {rank}):
        h, d = where[r]
        if h != host:
            return (f"rank {rank} ({host}) and its neighbour rank {r} ({h}) "
                    "are on different hosts")
        if d != dev and not can_access(dev, d):
            return (f"rank {rank}'s card {dev} has no peer access to its "
                    f"neighbour rank {r}'s card {d}")
    return None


def check_ring_peers(mesh):
    """Raises ValueError, on every rank alike, unless every rank of a CUDA
    mesh of several ranks can store into its ring neighbours' cards: the
    whole-ring kernel moves the carry itself, over peer access. Returns
    the ranks' (host, device) (None where nothing is checked)."""
    if mesh.world_size == 1 or mesh.platform != "cuda":
        return None
    where = mesh.all_gather_object((socket.gethostname(), str(mesh.device)))
    mine = ring_peer_problem(
        where, mesh.rank, lambda a, b: torch.cuda.can_device_access_peer(
            torch.device(a), torch.device(b)))
    problems = [p for p in mesh.all_gather_object(mine) if p]
    if problems:
        raise ValueError(
            "knn_comm='ring_pallas' on several cards stores each carry into "
            "the right neighbour's card from inside the ring kernel and "
            "needs peer access between neighbour cards: "
            + "; ".join(problems)
            + ". Use knn_comm='ring' or 'all_gather', whose transfers are "
            "NCCL calls"
        )
    return where


def ring_region(mesh, S, dim, G, n_super):
    """This rank's RingRegion for the geometry, its neighbours' mapped:
    made at the first ring call of the geometry on ``mesh`` (which must not
    be under a CUDA-graph capture: the IPC handles travel over the process
    group) and kept on the mesh."""
    key = (S, dim, G, n_super)
    region = mesh.ring_regions.get(key)
    if region is not None:
        return region
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the ring's peer regions are made at a geometry's first call, "
            "which must run eagerly, not under a CUDA-graph capture")
    n_blocks = ring_run_grid(S, dim, G, n_super, mesh.device)
    region = RingRegion(S, dim, G, n_super, mesh.device, n_blocks)
    if mesh.world_size > 1:
        every = mesh.all_gather_object((region.handle(), n_blocks))
        if any(nb != n_blocks for _, nb in every):
            raise RuntimeError(
                "the ring kernel's grid differs between ranks "
                f"({[nb for _, nb in every]}): every rank's card must run "
                "the same plan")
        right = (mesh.rank + 1) % mesh.world_size
        left = (mesh.rank - 1) % mesh.world_size
        mapped = {r: region.open(every[r][0]) for r in {right, left}}
        region.right, region.left = mapped[right], mapped[left]
    mesh.ring_regions[key] = region
    return region


def ring_run_cuda(q_pad, refs, region, out, rank, ndev, hops, T, G, n_super,
                  R_pad):
    """Launch hops [h0, h1) = ``hops`` of rank ``rank``'s ring on the card.

    ``q_pad`` (ndev * S, dim) holds every query shard, ``refs`` (E, dim) the
    rank's tile; ``region`` is its RingRegion with the neighbours mapped
    (or, on one card, other virtual ranks' regions); ``out`` = (vals, ids),
    (S, G * 128), receives the bins of shard (rank + 1) % ndev after the
    last hop, bit for bit ring_fold_reference's chain over the ranks. The
    kernel waits on the neighbours' flags: every rank of the ring must
    launch its hops too."""
    S = q_pad.shape[0] // ndev
    dim = q_pad.shape[1]
    E = refs.shape[0]
    dev = q_pad.device
    h0, h1 = hops
    if not q_pad.is_cuda or refs.device != dev or region.device != dev:
        raise ValueError("queries, refs and region must be on one CUDA card")
    if q_pad.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("the ring kernel takes float32 queries and refs")
    if not (1 <= dim <= MAX_DIM) or refs.shape[1] != dim:
        raise ValueError(f"ring kernel takes 1..{MAX_DIM} dims, got {dim}")
    if S * ndev != q_pad.shape[0] or not (0 <= h0 < h1 <= ndev):
        raise ValueError("q_pad must hold ndev equal shards, and hops a "
                         "non-empty range of 0..ndev")
    if T % _LANES or E > n_super * G * T or R_pad < n_super * G * T:
        raise ValueError("refs exceed the geometry's tiles")
    if ndev * R_pad >= 2**31:
        raise ValueError("ring kernel ids are int32: ndev * R_pad too large")
    if region.made_for[:5] != (S, dim, G, n_super, dev):
        raise ValueError(f"region made for (S, dim, G, n_super, device) = "
                         f"{region.made_for[:5]}, the ring is "
                         f"{(S, dim, G, n_super, dev)}")
    shape = (S, G * _LANES)
    _check_bins("out values", out[0], torch.float32, shape, dev)
    _check_bins("out ids", out[1], torch.int32, shape, dev)
    fn = _entry("graphem_ring_run_launch", ctypes.c_int,
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                + [ctypes.c_void_p])
    q_pad = q_pad.contiguous()
    refs = refs.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ring_fold.launches += 1
        rc = fn(q_pad.data_ptr(), refs.data_ptr(), region.base, region.right,
                region.left, out[0].data_ptr(), out[1].data_ptr(), rank, ndev,
                h0, h1, S, E, dim, T, G, n_super, R_pad,
                region.made_for[5], stream)
    _check_rc(rc, "kernel launch")
    return out


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


def _gather_top(bins, kk, mesh, S_pad, S_in):
    """(vals (S_in, kk), ids, R_pad) on every rank from this rank's merged
    bins of shard (rank + 1) % ndev."""
    vals_loc, idx_loc = _top_bins(*bins, kk)
    # one collective for both: the values travel bit-cast to int32 beside
    # the ids, (ndev, S_loc, 2 * kk)
    both = mesh.all_gather(torch.cat([vals_loc.view(torch.int32), idx_loc],
                                     dim=1))
    # shard a ended on rank (a - 1) % ndev: a roll, not an index list, which
    # would cost a host-to-device copy and a sync per call
    both = torch.roll(both, 1, dims=0).reshape(S_pad, 2 * kk)[:S_in]
    return both[:, :kk].contiguous().view(torch.float32), both[:, kk:]


def ring_binfold_topk(q_mid, mid_loc, kk, *, mesh, recall_target=0.95):
    """Global approximate top-kk over every rank's ref tile, by the ring.

    Call on every rank of ``mesh`` with the same ``q_mid`` (S, d) and the
    rank's own tile ``mid_loc`` (E_loc, d), of equal length on every rank
    (the engine's 1e30 pad rows fold harmlessly). Returns
    (vals (S, kk) f32, ids (S, kk) int32, R_pad), the same on every rank,
    where an id is ``folder_rank * R_pad + local_position``. On the cards
    this is one launch of the ring kernel (the carries move inside it) and
    one all_gather, capturable in a CUDA graph once the geometry's first
    call has made the peer regions.
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
    if q.is_cuda:
        # one launch runs every hop; the carries travel inside it
        region = ring_region(mesh, S_loc, q.shape[1], G, n_super)
        out = (torch.empty(shape, dtype=torch.float32, device=q.device),
               torch.empty(shape, dtype=torch.int32, device=q.device))
        ring_run_cuda(q, refs, region, out, i, ndev, (0, ndev), T, G,
                      n_super, R_pad)
        return (*_gather_top(out, kk, mesh, S_pad, S_in), R_pad)
    # the CPU (gloo): the plain fold per hop, the carry by send_recv
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
                  n_super, out=slot)
        if h < ndev - 1:
            # the merged carry goes right; the next shard's comes from the
            # left into the other slot, whose previous send was waited on
            carry = slots[(h + 1) % 2]
            works = mesh.send_recv(list(slot), list(carry),
                                   dst=(i + 1) % ndev, src=(i - 1) % ndev)
            for w in works:
                w.wait()
    return (*_gather_top(slots[(ndev - 1) % 2], kk, mesh, S_pad, S_in),
            R_pad)


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


def ring_binfold_topk_transfer(q, tiles, kk, recall_target=0.95,
                               concurrent=False, calls=1):
    """``ring_binfold_topk_virtual`` through the ring kernel's transfer
    path on one card: ``len(tiles)`` virtual ranks, each with its own
    RingRegion, whose neighbours are the other virtual ranks' regions, so
    every carry goes through the kernel's stores into the neighbour's slot
    and its flags.

    ``concurrent=False`` launches one hop of one rank at a time, in ring
    order, so that every wait is met when the launch starts;
    ``concurrent=True`` launches every rank's whole ring at once, one
    stream each, on 1/ndev of the resident blocks each, so that all are
    resident together and wait on each other as the ranks of a real ring
    do. ``calls`` rings run one after another on the same regions (the
    epochs and flags run on). Returns ([(vals (S, kk), ids (S, kk) int32)
    per call], R_pad).
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
    dev, dim = qp.device, qp.shape[1]
    tiles = [t.to(torch.float32).contiguous() for t in tiles]
    n_blocks = ring_run_grid(S_loc, dim, G, n_super, dev,
                             share=ndev if concurrent else 1)
    regions = [RingRegion(S_loc, dim, G, n_super, dev, n_blocks)
               for _ in range(ndev)]
    for r, region in enumerate(regions):
        region.right = regions[(r + 1) % ndev].base
        region.left = regions[(r - 1) % ndev].base
    shape = (S_loc, G * _LANES)
    results = []
    try:
        for _ in range(calls):
            outs = [(torch.empty(shape, dtype=torch.float32, device=dev),
                     torch.empty(shape, dtype=torch.int32, device=dev))
                    for _ in range(ndev)]

            def run(r, hops, outs=outs):
                ring_run_cuda(qp, tiles[r], regions[r], outs[r], r, ndev,
                              hops, T, G, n_super, R_pad)

            if concurrent:
                current = torch.cuda.current_stream(dev)
                streams = [torch.cuda.Stream(dev) for _ in range(ndev)]
                for r, st in enumerate(streams):
                    st.wait_stream(current)
                    with torch.cuda.stream(st):
                        run(r, (0, ndev))
                for st in streams:
                    current.wait_stream(st)
            else:
                for h in range(ndev):
                    for r in range(ndev):
                        run(r, (h, h + 1))
            # rank r ends with shard (r + 1) % ndev
            top = [_top_bins(*outs[(s - 1) % ndev], kk) for s in range(ndev)]
            results.append((torch.cat([v for v, _ in top])[:S_in],
                            torch.cat([i for _, i in top])[:S_in]))
        torch.cuda.synchronize(dev)
    finally:
        for region in regions:
            region.close()
    return results, R_pad
