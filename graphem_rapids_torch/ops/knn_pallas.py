"""Exact tiled kNN (the 'pallas' strategy): a hand-written CUDA kernel and
its plain version.

Counterpart of ``graphem_rapids_tpu/ops/knn_pallas.py``; the module keeps
its name because the strategy is called 'pallas' in the API. The kernel
(``csrc/knn_tiled.cu``) computes, for each query, the first k refs in
ascending (squared distance, index) order, without materializing the
(S, E) distance matrix:

- distances are accumulated coordinate by coordinate in order, in fp32,
  with no fused multiply-add;
- equal distances keep the smaller index;
- a ref whose squared distance is not below 3.0e38 (the engine's 1e30 pad
  slots give +inf) is never returned, and slots beyond the refs taken hold
  (3.0e38, 0), as the TPU kernel's initial carry gives.

``knn_tiled_reference`` is the plain PyTorch version: the wrapper runs it
for tensors on the CPU (the tests hold it against the JAX kernel in
interpret mode); for a CUDA tensor the wrapper launches the kernel or
raises. ``slice_plan``, ``knn_slices_reference`` and ``shown_bound`` model
the kernel's slices, their merge and the bound they share, so that the CPU
tests hold the plan to the plain version.
"""

import ctypes

import torch

from .. import _build
from ..utils import tracing

# Most neighbours per query: the TPU kernel's (S, 128) carry.
MAX_K = 128
_BIG = 3.0e38
# Ref chunk of the plain version: bounds its (S, chunk) working set.
_REF_CHUNK = 65536
# Pass 1 of the kernel: queries per block (8 warps of 4), slice lengths a
# multiple of 512 refs (so every staged tile but a slice's last is whole),
# and the fewest refs per slice.
QUERIES_PER_BLOCK = 32
_SLICE_ALIGN = 512
_MIN_SLICE = 2048


def knn_tiled_reference(queries, refs, k):
    """Plain PyTorch exact kNN: (indices (S, k) int32, values (S, k) f32).

    Loops over ref chunks of _REF_CHUNK; in each, the squared distances are
    accumulated coordinate by coordinate (d = 0; d = d + diff * diff),
    values not below 3.0e38 become 3.0e38, and the chunk's k smallest are
    taken with a stable sort and merged behind the carry by a second stable
    sort, so a smaller index wins every tie. The carry starts as
    (3.0e38, 0), which fills the slots no ref reaches.
    """
    S, dim = queries.shape
    E = refs.shape[0]
    q = queries.to(torch.float32)
    r = refs.to(torch.float32)
    vals = torch.full((S, k), _BIG, dtype=torch.float32, device=q.device)
    idx = torch.zeros((S, k), dtype=torch.int64, device=q.device)
    for lo in range(0, E, _REF_CHUNK):
        rc = r[lo:lo + _REF_CHUNK]
        d = torch.zeros((S, rc.shape[0]), dtype=torch.float32, device=q.device)
        for c in range(dim):
            diff = q[:, c:c + 1] - rc[:, c]
            d = d + diff * diff
        d = torch.where(d < _BIG, d, torch.full_like(d, _BIG))
        top_v, top_p = torch.sort(d, dim=1, stable=True)
        m = min(k, rc.shape[0])
        cand_v = torch.cat([vals, top_v[:, :m]], dim=1)
        cand_i = torch.cat([idx, top_p[:, :m] + lo], dim=1)
        vals, order = torch.sort(cand_v, dim=1, stable=True)
        vals = vals[:, :k]
        idx = torch.gather(cand_i, 1, order[:, :k])
    return idx.to(torch.int32), vals


def knn_slices_reference(queries, refs, k, n_slices, slice_len,
                         threshold=None):
    """Plain model of the kernel's two passes: (indices, values) as
    knn_tiled_reference gives them.

    Pass 1: each slice [p * slice_len, (p+1) * slice_len) keeps its own
    first k refs in (value, index) order. ``threshold`` (S,) stands for the
    per-query bound the kernel's slices share: a slice takes only refs with
    d <= threshold, so its list is its first k among those, then
    (3.0e38, 0). Any threshold at or above the query's final k-th value
    leaves the answer unchanged. Pass 2: the lists, in slice order, are
    merged by (value, index).
    """
    S = queries.shape[0]
    lists_v, lists_i = [], []
    for p in range(n_slices):
        lo = p * slice_len
        idx, vals = knn_tiled_reference(queries, refs[lo:lo + slice_len], k)
        idx = idx + lo
        if threshold is not None:
            drop = vals > threshold[:, None]
            vals = torch.where(drop, torch.full_like(vals, _BIG), vals)
            idx = torch.where(drop, torch.zeros_like(idx), idx)
        # entries past the slice's refs are (3.0e38, 0), not (3.0e38, lo)
        idx = torch.where(vals < _BIG, idx, torch.zeros_like(idx))
        lists_v.append(vals)
        lists_i.append(idx)
    cand_v = torch.cat(lists_v, dim=1)
    cand_i = torch.cat(lists_i, dim=1).to(torch.int64)
    # lexicographic (value, index): sort by index, then stably by value
    by_i = torch.argsort(cand_i, dim=1, stable=True)
    cand_v, cand_i = torch.gather(cand_v, 1, by_i), torch.gather(cand_i, 1, by_i)
    by_v = torch.argsort(cand_v, dim=1, stable=True)[:, :k]
    vals = torch.gather(cand_v, 1, by_v).reshape(S, k)
    idx = torch.gather(cand_i, 1, by_v).reshape(S, k)
    return idx.to(torch.int32), vals


def shown_bound(lists_v, k):
    """Plain model of the bound the kernel's slices share: (S,) values at
    or above each query's final k-th value.

    ``lists_v`` (n_slices, S, k) holds each slice's sorted list values
    (3.0e38 past its real entries). A slice shows the value at rank
    r = ceil(k / n_slices) of its list; m = ceil(k / r) shown values from
    distinct slices stand for m * r >= k refs, so the m-th smallest shown
    value bounds the k-th value from above. With fewer than m real shown
    values the bound is 3.0e38.
    """
    n = lists_v.shape[0]
    r = -(-k // n)
    m = -(-k // r)
    shown = lists_v[:, :, r - 1]
    return torch.sort(shown, dim=0).values[m - 1]


def _kernel_fn():
    fn = _build.load("knn_tiled").graphem_knn_tiled_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


_occupancy = {}


def _blocks_per_sm(device, dim, k):
    """Resident pass-1 blocks per SM, as the card reports for the kernel
    instantiated for (dim, k)."""
    key = (device, min(dim, 9), _cdiv(k, 32))
    if key not in _occupancy:
        fn = _build.load("knn_tiled").graphem_knn_tiled_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        with torch.cuda.device(device):
            n = fn(dim, k)
        if n < 1:
            raise RuntimeError(f"tiled kNN occupancy query failed: {n}")
        _occupancy[key] = n
    return _occupancy[key]


def slice_plan(S, E, sm_count, blocks_per_sm):
    """(n_slices, slice_len) of the kernel's pass 1.

    The grid is (query blocks, slices). Slices are cut so that the grid is
    one whole wave of the card's resident blocks (sm_count *
    blocks_per_sm) where the query blocks leave room, with at least
    _MIN_SLICE refs per slice; slice_len is a multiple of _SLICE_ALIGN, so
    only the last slice is ragged.
    """
    if E == 0:
        return 1, _SLICE_ALIGN
    q_blocks = _cdiv(S, QUERIES_PER_BLOCK)
    n = max(1, (sm_count * blocks_per_sm) // q_blocks)
    n = min(n, _cdiv(E, _MIN_SLICE), 65535)
    slice_len = _cdiv(_cdiv(E, n), _SLICE_ALIGN) * _SLICE_ALIGN
    return _cdiv(E, slice_len), slice_len


def _cdiv(a, b):
    return -(-a // b)


def knn_tiled_cuda(queries, refs, k):
    """Launch the CUDA kernel; same outputs as knn_tiled_reference."""
    S, dim = queries.shape
    E = refs.shape[0]
    if not queries.is_cuda or queries.device != refs.device:
        raise ValueError("queries and refs must be on the same CUDA device")
    if queries.dtype != torch.float32 or refs.dtype != torch.float32:
        raise TypeError("the tiled kNN kernel takes float32 queries and refs")
    if refs.ndim != 2 or refs.shape[1] != dim or dim < 1:
        raise ValueError(f"refs must be (E, {dim}), got {tuple(refs.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_pallas supports 1 <= k <= {MAX_K}, got {k}")
    if E >= 2**31 - 2**20:
        raise ValueError("the tiled kNN kernel's indices are int32: too many refs")
    out_v = torch.empty((S, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((S, k), dtype=torch.int32, device=queries.device)
    if S == 0:
        return out_i, out_v
    queries = queries.contiguous()
    refs = refs.contiguous()
    dev = queries.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_slices, slice_len = slice_plan(S, E, sm_count,
                                     _blocks_per_sm(dev, dim, k))
    part = (n_slices, S, k) if n_slices > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_i = torch.empty(part, dtype=torch.int32, device=dev)
    thresh = torch.empty((S * (1 + n_slices),), dtype=torch.float32,
                         device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        knn_pallas.launches += 1
        rc = fn(queries.data_ptr(), refs.data_ptr(), part_v.data_ptr(),
                part_i.data_ptr(), thresh.data_ptr(), out_v.data_ptr(),
                out_i.data_ptr(), S, E, dim, k, n_slices, slice_len, stream)
    if rc != 0:
        raise RuntimeError(f"tiled kNN kernel launch failed: CUDA error {rc}")
    return out_i, out_v


def knn_pallas(queries, refs, k, tile=1024):
    """Exact kNN: (indices (S, k) int32, sq_distances (S, k) float32).

    The CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    ``tile`` is accepted for API parity with the JAX package; results do
    not depend on it, and the kernel chooses its own blocking.
    ``knn_pallas.launches`` counts kernel launches on the card.
    """
    if k > MAX_K:
        raise ValueError(f"knn_pallas supports k <= {MAX_K}, got {k}")
    if queries.is_cuda:
        return knn_tiled_cuda(queries.to(torch.float32),
                              refs.to(torch.float32), int(k))
    return knn_tiled_reference(queries, refs, int(k))


knn_pallas.launches = 0
tracing.counts_launches(knn_pallas)
