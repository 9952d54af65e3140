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
raises.
"""

import ctypes

import torch

from .. import _build

# Most neighbours per query: the TPU kernel's (S, 128) carry.
MAX_K = 128
_BIG = 3.0e38
# Ref chunk of the plain version: bounds its (S, chunk) working set.
_REF_CHUNK = 65536
# Pass 1 of the kernel: warps per block, blocks per SM it aims for, and the
# fewest refs per slice.
_WARPS_PER_BLOCK = 4
_BLOCKS_PER_SM = 8
_MIN_SLICE = 4096


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


def _kernel_fn():
    fn = _build.load("knn_tiled").graphem_knn_tiled_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def slice_plan(S, E, sm_count):
    """(n_slices, slice_len) of the kernel's pass 1: enough (query block,
    ref slice) blocks for _BLOCKS_PER_SM per SM, with at least _MIN_SLICE
    refs per slice; slice_len is a multiple of 32 (one ref per lane per
    step)."""
    if E == 0:
        return 1, 32
    q_blocks = _cdiv(S, _WARPS_PER_BLOCK)
    n = min(_cdiv(_BLOCKS_PER_SM * sm_count, q_blocks), _cdiv(E, _MIN_SLICE),
            65535)
    slice_len = _cdiv(_cdiv(E, n), 32) * 32
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
    sm_count = torch.cuda.get_device_properties(
        queries.device).multi_processor_count
    n_slices, slice_len = slice_plan(S, E, sm_count)
    part = (n_slices, S, k) if n_slices > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=queries.device)
    part_i = torch.empty(part, dtype=torch.int32, device=queries.device)
    fn = _kernel_fn()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        knn_pallas.launches += 1
        rc = fn(queries.data_ptr(), refs.data_ptr(), part_v.data_ptr(),
                part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                S, E, dim, k, n_slices, slice_len, stream)
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
