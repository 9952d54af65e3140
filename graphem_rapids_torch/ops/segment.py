"""Deterministic row sums: ``out[ids[j]] += values[j]``, each row's terms
added in ascending j.

The port's one float accumulator. The JAX package sums with XLA's
``segment_sum`` and ``.at[].add``, which add in a fixed order, so one seed
gives one trajectory. PyTorch's ``index_add_`` on a card adds with float
atomics in an order that changes from run to run. Here the order is fixed,
and it is the CPU's: ``index_add_`` on the CPU adds a row's terms in
ascending contribution order, so the card's result is the same on every run
and bit-equal to the CPU's on the same inputs.

Two forms, both in place on ``out`` and both adding onto its current rows,
as ``out.index_add_(0, ids, values)`` does:

- ``segment_sum(out, ids, values)``, for ids known only when the step runs
  (the 4*S*k endpoints of ``intersection_forces``; outside the engines'
  steps, the unplanned ``spring_forces`` and the edge-sharded sum of a
  step built without a table). On a card the ids are cut into tiles of at
  most ``TILE`` consecutive terms (``tile_shape``), as many as there are;
  the tile sort's launch sorts each tile stably as int32 keys (n < 2^31)
  and marks each row's tiles in a mask of ``mask_words(T)`` 64-bit words a
  row (rows * ceil(M / 65536) words of scratch), the sum's launch adds each
  row's runs tile by tile. Nothing reads back to the host, so the form is
  captured with the layout step;
- ``segment_sum_sorted(out, keys, values, perm=None)``, for ids sorted once
  when their plan or table is built (the block-fold plan's ``block_hub``,
  the scatter plan, the tables' COO overflow rows, the Chebyshev SpMV's
  overflow): ``keys`` ascending, and ``values[perm[i]]`` the i-th term in
  key order (``perm`` None: ``values`` are in key order already); a call
  only sums.

The kernel (``csrc/segment_sum.cu``) adds each row's terms in order in one
thread, from the row's current value, with ``__fadd_rn``.
``segment_sum_reference`` is its plain version, the CPU's ``index_add_``,
and ``sort_tiles_reference`` the tile sort's, a stable ``torch.sort`` of
each tile; the wrappers run them for tensors on the CPU. For CUDA tensors
they launch the kernels or raise: nothing here falls back to
``index_add_``'s atomics or to ``torch.sort``. ``segment_sum.launches``
counts the sum's launches, by either form, and ``sort_tiles.launches`` the
tile sort's (one per dynamic call). Ids must lie in [0, rows of out); the
card does not read them back to check.
"""

import ctypes

import torch

from .. import _build

# Terms per tile of the step's ids: one block of the kernel sorts a tile,
# a term a thread.
TILE = 1024
# The key that pads the last tile (the kernel skips it): past any row.
PAD_KEY = 2**31 - 1


def tile_shape(M):
    """(T, L): the tiles of ``M`` consecutive terms, L <= TILE and
    T * L >= M with fewer than T pads."""
    T = max(1, -(-M // TILE))
    return T, -(-M // T)


def mask_words(T):
    """64-bit words of a row's tile mask: a bit per tile."""
    return -(-T // 64)


def sort_tiles_reference(ids, rows):
    """Plain version of the tile sort: (keys (T * L,) int32, perm (T * L,)
    int64, T, L, mask (rows, mask_words(T)) int64 or None). Tile t holds
    terms [t * L, (t + 1) * L) in key order, equal keys in term order,
    ``perm`` their places within the tile; PAD_KEY fills the last tile's
    tail. With several tiles, bit t % 64 of ``mask[r, t // 64]`` is set
    when tile t holds row r."""
    M = ids.shape[0]
    T, L = tile_shape(M)
    keys = ids.to(torch.int32)
    if T * L > M:
        keys = torch.cat([keys, keys.new_full((T * L - M,), PAD_KEY)])
    keys, perm = torch.sort(keys.view(T, L), dim=1, stable=True)
    mask = None
    if T > 1:
        W = mask_words(T)
        bits = torch.zeros((rows, W * 64), dtype=torch.bool,
                           device=ids.device)
        real = keys != PAD_KEY
        tile = torch.arange(T, device=ids.device)[:, None].expand(T, L)
        bits[keys[real].long(), tile[real]] = True
        weights = torch.tensor([1 << t for t in range(63)] + [-(1 << 63)],
                               dtype=torch.int64, device=ids.device)
        mask = (bits.view(rows, W, 64).long() * weights).sum(dim=2)
    return keys.reshape(-1), perm.reshape(-1), T, L, mask


def _sort_fn():
    fn = _build.load("segment_sum").graphem_segment_sort_tiles_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def sort_tiles(ids, rows):
    """The (M,) ids (in [0, rows)) as stably sorted tiles, as
    sort_tiles_reference gives them: on a card by the kernel's block sort,
    any number of tiles, on the CPU by the plain version."""
    if not ids.is_cuda:
        return sort_tiles_reference(ids, rows)
    if ids.dtype not in (torch.int32, torch.int64) or ids.ndim != 1:
        raise TypeError(f"sort_tiles takes int32 or int64 ids of one "
                        f"dimension, got {ids.dtype} {tuple(ids.shape)}")
    M = ids.shape[0]
    T, L = tile_shape(M)
    dev = ids.device
    keys = torch.empty(T * L, dtype=torch.int32, device=dev)
    perm = torch.empty(T * L, dtype=torch.int64, device=dev)
    if M == 0:
        return keys, perm, T, L, None
    ids = ids.contiguous()
    W = mask_words(T) if T > 1 else 0
    mask = torch.zeros((rows, W), dtype=torch.int64, device=dev) \
        if T > 1 else None
    fn = _sort_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        sort_tiles.launches += 1
        rc = fn(ids.data_ptr(), ids.element_size(), M, T, L,
                keys.data_ptr(), perm.data_ptr(),
                None if mask is None else mask.data_ptr(), W, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum tile sort launch failed: CUDA "
                           f"error {rc}")
    return keys, perm, T, L, mask


def segment_sum_reference(out, keys, values, perm=None):
    """Plain version: ``out.index_add_(0, keys, values[perm])`` (the CPU's
    loop adds each row's terms in ascending order)."""
    return out.index_add_(0, keys, values if perm is None else values[perm])


def _kernel_fn():
    fn = _build.load("segment_sum").graphem_segment_sum_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def segment_sum_cuda(out, keys, values, perm=None, tiles=1, mask=None):
    """Launch the kernel on CUDA tensors, in place on ``out``; returns
    ``out``. ``keys`` (T * L,) int32 or int64 are ``tiles`` = T tiles of L,
    each sorted ascending (PAD_KEY, or the int64 maximum, pads); tile t's
    position j holds term t * L + perm[t * L + j] (``perm`` int64, or None
    for terms in key order). Several tiles take int32 keys and the tile
    sort's (rows, mask_words(T)) ``mask``. ``values`` (terms, d) or
    (terms,) and ``out`` (rows, d) or (rows,) are float32. With one tile
    this is segment_sum_reference, bit for bit."""
    T = int(tiles)
    if not (out.is_cuda and keys.device == out.device
            and values.device == out.device
            and (perm is None or perm.device == out.device)
            and (mask is None or mask.device == out.device)):
        raise ValueError("segment_sum_cuda takes CUDA tensors on one device")
    if out.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError(f"segment_sum_cuda takes float32 values and out, got "
                        f"{values.dtype} and {out.dtype}")
    if keys.dtype not in (torch.int32, torch.int64) or keys.ndim != 1:
        raise TypeError(f"segment_sum_cuda takes int32 or int64 keys of one "
                        f"dimension, got {keys.dtype} {tuple(keys.shape)}")
    if out.ndim not in (1, 2) or values.shape[1:] != out.shape[1:]:
        raise ValueError(f"values {tuple(values.shape)} and out "
                         f"{tuple(out.shape)} rows differ")
    if not out.is_contiguous():
        raise ValueError("segment_sum_cuda adds into a contiguous out")
    if T < 1 or keys.shape[0] % T:
        raise ValueError(f"{keys.shape[0]} keys are not {T} equal tiles")
    L = keys.shape[0] // T
    W = mask_words(T) if T > 1 else 0
    if (T > 1) != (mask is not None) or (
            mask is not None and (mask.dtype != torch.int64
                                  or mask.shape != (out.shape[0], W)
                                  or not mask.is_contiguous())):
        raise ValueError("several tiles take the tile sort's (rows, "
                         "mask_words(T)) int64 mask, one tile none")
    if T > 1 and keys.dtype != torch.int32:
        raise TypeError("several tiles take the tile sort's int32 keys")
    if perm is not None and (perm.dtype != torch.int64
                             or perm.shape != keys.shape):
        raise TypeError(f"perm must be int64 like keys {tuple(keys.shape)}, "
                        f"got {perm.dtype} {tuple(perm.shape)}")
    if values.shape[0] > T * L or (T == 1 and values.shape[0] != L):
        raise ValueError(f"{values.shape[0]} terms for {T} tiles of {L} keys")
    if L == 0:
        return out
    d = out.shape[1] if out.ndim == 2 else 1
    keys = keys.contiguous()
    values = values.contiguous()
    fn = _kernel_fn()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        segment_sum.launches += 1
        rc = fn(keys.data_ptr(), keys.element_size(),
                None if perm is None else perm.contiguous().data_ptr(),
                None if mask is None else mask.data_ptr(), W,
                values.data_ptr(), out.data_ptr(), T, L, d, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def segment_sum_sorted(out, keys, values, perm=None):
    """``out[keys[i]] += values[perm[i]]`` in order of i, in place; returns
    ``out``. ``keys`` must be sorted ascending, as a plan's are; ``perm``
    None takes ``values`` in key order."""
    if out.is_cuda:
        return segment_sum_cuda(out, keys, values, perm)
    return segment_sum_reference(out, keys, values, perm)


def segment_sum(out, ids, values):
    """``out.index_add_(0, ids, values)`` with each row's terms added in
    ascending order, in place; returns ``out``. On a card the ids are
    sorted on the card first, tile by tile (``sort_tiles``)."""
    if out.is_cuda:
        if ids.shape[0] == 0:
            return out
        keys, perm, T, _, mask = sort_tiles(ids, out.shape[0])
        return segment_sum_cuda(out, keys, values, perm, tiles=T, mask=mask)
    return segment_sum_reference(out, ids, values)


segment_sum.launches = 0
sort_tiles.launches = 0
