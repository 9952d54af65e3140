"""Bin-fold approximate kNN: a hand-written CUDA kernel and its plain version.

Counterpart of ``graphem_rapids_tpu/ops/knn_binfold.py``. The kernel
(``csrc/binfold.cu``) fuses the squared distances from S queries to E refs
with a per-bin running arg-min, so only (S, G*128) candidates reach device
memory; an exact ``torch.topk`` over those bins then gives the neighbours.

Recall model (unchanged from the TPU kernel): each ref lands in one of G*128
fixed bins, bin ``((p // T) % G) * 128 + p % 128`` for flat position p; a
true neighbour is lost only when a nearer ref shares its bin. ``params_for``
sizes G for a structural recall target.

``binfold_bins_reference`` is the plain PyTorch version of the kernel. The
wrapper runs it for tensors on the CPU (the tests hold it against the JAX
kernel in interpret mode); for a CUDA tensor the wrapper launches the kernel
or raises.
"""

import ctypes
import math

import torch

from .. import _build
from ..utils import tracing

# Pad coordinate for ref positions past E inside the last super-tile: the
# squared distance ~1e30 stays finite (an inf pad would give inf - inf).
_PAD_COORD = 1.0e15
_BIG = 3.0e38
_LANES = 128

# The TPU kernel carries indices in fp32 lanes, exact below 2^24 refs per
# launch. Indices here are int32, but the same segment rule is kept above
# MAX_REFS so that results stay identical to the JAX package's.
MAX_REFS = 1 << 24
MAX_SEGMENTS = 16
MAX_REFS_SEGMENTED = MAX_REFS * MAX_SEGMENTS
# Auto-selection gates (models/embedder.py _resolved_strategy).
MAX_DIM = 8
MAX_K = 48
_MIN_G, _MAX_G = 24, 64


def params_for(k, recall_target=0.95, T=2048):
    """(T, G) sized so structural bin recall >= recall_target.

    Expected recall ~ exp(-k^2 / (2 * bins)) => bins >= k^2 / (2 * -ln r),
    with G clamped to [24, 64].
    """
    r = min(max(float(recall_target), 0.5), 0.999)
    bins_needed = (k * k) / (2.0 * -math.log(r))
    G = int(min(_MAX_G, max(_MIN_G, -(-bins_needed // 128))))
    return T, G


def _geometry(E, T, G):
    """(G, n_super) after the small-E clamp G = min(G, n_tiles)."""
    n_tiles = -(-E // T)
    G = min(G, n_tiles)
    return G, -(-n_tiles // G)


def binfold_bins_reference(queries, refs, T, G, n_super):
    """Plain PyTorch bin fold: (vals (S, G*128) f32, idx (S, G*128) int32).

    Squared distances to the refs padded with _PAD_COORD to
    E_pad = n_super*G*T, accumulated coordinate by coordinate in order,
    viewed as (S, n_super, G, T/128, 128) and reduced per bin by the first
    arg-min over (n_super, T/128) in visit order; a bin whose minimum is not
    below 3.0e38 keeps (3.0e38, 0), as the kernel's strict-< fold does.
    """
    S, dim = queries.shape
    E = refs.shape[0]
    E_pad = n_super * G * T
    q = queries.to(torch.float32)
    r = torch.full((E_pad, dim), _PAD_COORD, dtype=torch.float32,
                   device=refs.device)
    r[:E] = refs.to(torch.float32)
    d = torch.zeros((S, E_pad), dtype=torch.float32, device=q.device)
    for c in range(dim):
        diff = q[:, c:c + 1] - r[:, c]
        d = d + diff * diff
    C = T // _LANES
    d = d.view(S, n_super, G, C, _LANES).permute(0, 2, 4, 1, 3)
    d = d.reshape(S, G * _LANES, n_super * C)
    vals, j = torch.min(d, dim=2)
    # torch.min along a dim returns the first minimal index
    s, c = j // C, j % C
    bins = torch.arange(G * _LANES, device=q.device)
    p = (s * G + bins // _LANES) * T + c * _LANES + bins % _LANES
    keep = vals < _BIG
    vals = torch.where(keep, vals, torch.full_like(vals, _BIG))
    idx = torch.where(keep, p, torch.zeros_like(p)).to(torch.int32)
    return vals, idx


def fold_queries_per_block(dim):
    """Queries each kernel thread keeps in registers: 16 at d <= 3, else 8."""
    return 16 if dim <= 3 else 8


def fold_plan(S, G, n_super, sm_count, dim, blocks_per_sm):
    """(qb, n_qblk, units, n_blocks) of the kernel's work plan.

    The work is ``units`` = G * n_qblk * n_super units (bin group g, query
    block of qb queries, super-tile s), numbered in that order, s fastest.
    The grid is n_blocks = min(units, sm_count * blocks_per_sm): one wave
    of the card's resident blocks, and block b takes the units of
    ``fold_ranges(units, n_blocks)[b]``.
    """
    qb = fold_queries_per_block(dim)
    n_qblk = -(-S // qb)
    units = G * n_qblk * n_super
    return qb, n_qblk, units, max(1, min(units, sm_count * blocks_per_sm))


def fold_ranges(units, n_blocks):
    """Block b's units [b * units // n_blocks, (b+1) * units // n_blocks)."""
    return [(b * units // n_blocks, (b + 1) * units // n_blocks)
            for b in range(n_blocks)]


def fold_runs(units, n_blocks, n_super):
    """Each block's runs, as (block, segment, s0, s1): the super-tiles
    [s0, s1) of segment (g, query block) = divmod(segment, n_qblk) that the
    block folds. A run with (s0, s1) != (0, n_super) is a piece."""
    runs = []
    for b, (u0, u1) in enumerate(fold_ranges(units, n_blocks)):
        u = u0
        while u < u1:
            seg, s0 = divmod(u, n_super)
            s1 = min(n_super, s0 + u1 - u)
            runs.append((b, seg, s0, s1))
            u += s1 - s0
    return runs


def pack_keys(vals, idx):
    """64-bit keys (bits(value) << 32) | index, as int64: for values >= +0
    they order as (value, index)."""
    hi = vals.to(torch.float32).view(torch.int32).to(torch.int64)
    return (hi << 32) | (idx.to(torch.int64) & 0xFFFFFFFF)


def unpack_keys(keys):
    vals = (keys >> 32).to(torch.int32).view(torch.float32)
    return vals, (keys & 0xFFFFFFFF).to(torch.int32)


def binfold_pieces_reference(queries, refs, T, G, n_super, n_blocks):
    """Plain model of the kernel's plan: (vals, idx) as
    binfold_bins_reference gives them.

    Each run of ``fold_runs`` folds its super-tiles for its bin group and
    query block in visit order (first strict minimum, from (3.0e38, 0));
    the runs of a segment are then combined by the minimum of their
    ``pack_keys``.
    """
    S, dim = queries.shape
    E = refs.shape[0]
    E_pad = n_super * G * T
    C = T // _LANES
    qb, n_qblk, units, _ = fold_plan(S, G, n_super, 1, dim, 1)
    q = torch.zeros((n_qblk * qb, dim), dtype=torch.float32,
                    device=queries.device)
    q[:S] = queries.to(torch.float32)
    r = torch.full((E_pad, dim), _PAD_COORD, dtype=torch.float32,
                   device=refs.device)
    r[:E] = refs.to(torch.float32)
    d = torch.zeros((q.shape[0], E_pad), dtype=torch.float32, device=q.device)
    for c in range(dim):
        diff = q[:, c:c + 1] - r[:, c]
        d = d + diff * diff
    # (query, s, g, c, lane), p = (s * G + g) * T + c * 128 + lane
    d = d.view(-1, n_super, G, C, _LANES)
    p_all = torch.arange(E_pad, device=q.device).view(n_super, G, C, _LANES)
    keys = torch.full((q.shape[0], G * _LANES), 0, dtype=torch.int64,
                      device=q.device)
    keys[:] = pack_keys(torch.tensor(_BIG), torch.tensor(0))
    for _, seg, s0, s1 in fold_runs(units, n_blocks, n_super):
        g, qblk = divmod(seg, n_qblk)
        rows = slice(qblk * qb, (qblk + 1) * qb)
        dd = d[rows, s0:s1, g].reshape(qb, (s1 - s0) * C, _LANES)
        vals, j = torch.min(dd, dim=1)  # the first minimum in visit order
        p = p_all[s0:s1, g].reshape((s1 - s0) * C, _LANES)
        p = torch.gather(p.expand(qb, -1, -1), 1, j[:, None, :])[:, 0]
        keep = vals < _BIG
        vals = torch.where(keep, vals, torch.full_like(vals, _BIG))
        p = torch.where(keep, p, torch.zeros_like(p))
        cols = slice(g * _LANES, (g + 1) * _LANES)
        keys[rows, cols] = torch.minimum(keys[rows, cols], pack_keys(vals, p))
    vals, idx = unpack_keys(keys[:S])
    return vals, idx


def _kernel_fn():
    fn = _build.load("binfold").graphem_binfold_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


_occupancy = {}


def kernel_blocks_per_sm(lib, entry, device, dim):
    """Resident blocks per SM of a fold kernel for ``dim``, as the card
    reports through the library's occupancy entry ``entry``."""
    key = (lib, device, dim)
    if key not in _occupancy:
        fn = getattr(_build.load(lib), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        with torch.cuda.device(device):
            n = fn(dim)
        if n < 1:
            raise RuntimeError(f"{lib} occupancy query failed: {n}")
        _occupancy[key] = n
    return _occupancy[key]


def _blocks_per_sm(device, dim):
    """Resident blocks per SM of the bin-fold kernel for ``dim``."""
    return kernel_blocks_per_sm("binfold", "graphem_binfold_blocks_per_sm",
                                device, dim)


def fold_scratch(S, dim, G, n_super, device, blocks_per_sm):
    """(n_blocks, part_v, part_i, seg_done): the grid of the fold's plan
    on ``device`` and its scratch, the pieces' (n_blocks, 2, qb, 128)
    values and indices and the (G * n_qblk,) segment counts (zeroed by
    each launch)."""
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    qb, n_qblk, _, n_blocks = fold_plan(S, G, n_super, sm_count, dim,
                                        blocks_per_sm)
    shape = (n_blocks, 2, qb, _LANES)
    return (n_blocks,
            torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty((G * n_qblk,), dtype=torch.int32, device=device))


def binfold_bins_cuda(queries, refs, T, G, n_super):
    """Launch the CUDA bin fold; same outputs as binfold_bins_reference."""
    S, dim = queries.shape
    E = refs.shape[0]
    if not queries.is_cuda or queries.device != refs.device:
        raise ValueError("queries and refs must be on the same CUDA device")
    if queries.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("the binfold kernel takes float32 queries and refs")
    if not (1 <= dim <= MAX_DIM) or refs.shape[1] != dim:
        raise ValueError(f"binfold kernel takes 1..{MAX_DIM} dims, got {dim}")
    if T % _LANES:
        raise ValueError(f"T must be a multiple of {_LANES}, got {T}")
    if n_super * G * T >= 2**31:
        raise ValueError("binfold kernel indices are int32: too many refs")
    if E > n_super * G * T:
        raise ValueError(f"{E} refs exceed the {n_super} x {G} x {T} tiles")
    queries = queries.contiguous()
    refs = refs.contiguous()
    dev = queries.device
    out_vals = torch.empty((S, G * _LANES), dtype=torch.float32, device=dev)
    out_idx = torch.empty((S, G * _LANES), dtype=torch.int32, device=dev)
    if S == 0:
        return out_vals, out_idx
    n_blocks, part_v, part_i, seg_done = fold_scratch(
        S, dim, G, n_super, dev, _blocks_per_sm(dev, dim))
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        knn_binfold.launches += 1
        rc = fn(queries.data_ptr(), refs.data_ptr(), out_vals.data_ptr(),
                out_idx.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
                seg_done.data_ptr(), S, E, dim, T, G, n_super, n_blocks,
                stream)
    if rc != 0:
        raise RuntimeError(f"binfold kernel launch failed: CUDA error {rc}")
    return out_vals, out_idx


def binfold_bins(queries, refs, T, G, n_super):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if queries.is_cuda:
        return binfold_bins_cuda(queries, refs, T, G, n_super)
    return binfold_bins_reference(queries, refs, T, G, n_super)


def _binfold_padded(queries, refs, k, T, G):
    """Bin fold + exact top-k over the bin candidates (one launch)."""
    G, n_super = _geometry(refs.shape[0], T, G)
    vals, idx = binfold_bins(
        queries.to(torch.float32), refs.to(torch.float32), T, G, n_super
    )
    top, pos = torch.topk(vals, k, dim=1, largest=False, sorted=True)
    return torch.gather(idx, 1, pos), top


def _binfold_segments(queries, refs, k, T, G, seg, n_seg):
    """Per-segment launches + exact top-k merge for E > MAX_REFS."""
    E = refs.shape[0]
    vals_all, idx_all = [], []
    for s in range(n_seg):
        r = refs[s * seg:min((s + 1) * seg, E)]
        idx_s, vals_s = _binfold_padded(queries, r, k, T, G)
        idx_all.append(idx_s + s * seg)
        vals_all.append(vals_s)
    vals = torch.cat(vals_all, dim=1)
    idx = torch.cat(idx_all, dim=1)
    top, pos = torch.topk(vals, k, dim=1, largest=False, sorted=True)
    return torch.gather(idx, 1, pos), top


def segments(E, T):
    """(seg, n_seg): the bin fold over E refs launches once per segment of
    seg refs. Up to MAX_REFS refs that is one segment of all E; past it,
    as in the JAX package, n_seg equal segments, each a multiple of T and
    at most MAX_REFS (sized against the largest T-multiple under it), the
    last one short."""
    if E <= MAX_REFS:
        return E, 1
    seg_max = (MAX_REFS // T) * T
    n_seg = -(-E // seg_max)
    seg_raw = -(-E // n_seg)
    return -(-seg_raw // T) * T, n_seg


def knn_binfold(queries, refs, k, T=None, G=None, recall_target=0.95):
    """Approximate kNN via the bin fold.

    Returns (indices (S, k) int32, sq_distances (S, k) float32), like the
    other strategies in ops/knn.py. Ref sets beyond MAX_REFS are split into
    equal segments and merged exactly, up to MAX_REFS_SEGMENTED.
    ``knn_binfold.launches`` counts kernel launches on the card.
    """
    E = int(refs.shape[0])
    if E > MAX_REFS_SEGMENTED:
        raise ValueError(
            f"binfold supports at most {MAX_REFS_SEGMENTED} references "
            f"({MAX_SEGMENTS} segments), got {E}"
        )
    T_auto, G_auto = params_for(k, recall_target)
    T_use, G_use = int(T or T_auto), int(G or G_auto)
    if E > MAX_REFS:
        seg, n_seg = segments(E, T_use)
        idx, vals = _binfold_segments(queries, refs, int(k), T_use, G_use,
                                      seg, n_seg)
        return idx.to(torch.int32), vals
    bins = min(G_use, -(-E // T_use)) * _LANES
    if k > bins:
        raise ValueError(
            f"binfold keeps one candidate per bin: k={k} exceeds the "
            f"{bins} bins at E={E}; use the 'chunked' strategy"
        )
    idx, vals = _binfold_padded(queries, refs, int(k), T_use, G_use)
    return idx.to(torch.int32), vals


knn_binfold.launches = 0
tracing.counts_launches(knn_binfold)
