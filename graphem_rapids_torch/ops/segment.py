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

- ``segment_sum(out, ids, values)``, for ids known only when the step runs.
  On a card the form it takes goes by the number of terms M:

  - M up to ``cluster_max_terms(device)`` (``CLUSTER_MAX_TERMS`` =
    131,072 on an H100, from the shared memory a block may opt in to): one
    launch of ``segment_sum_cluster``, up to ``CLUSTER_GROUPS`` thread-block
    clusters of ``CLUSTER_BLOCKS`` blocks, each taking one range of rows
    (``cluster_rows``): a cluster sorts the terms of its rows in its
    distributed shared memory, so that each row's terms lie in one
    contiguous run, and adds each run from the lane at its start (the
    blocks' digit counts go through a global scratch, the keys stay in
    shared memory). Every call of the engines' steps takes it: the 4*S*k
    endpoints of ``intersection_forces`` (30,720 on the main path, 98,304
    for 'approx' at n_neighbors=48);
  - larger M (the unplanned ``spring_forces``, the edge-sharded sum of a
    step built without a table, a step of 4*S*k past the capacity): the
    ids cut into tiles of at most ``TILE`` consecutive terms
    (``tile_shape``): the tile sort's launch sorts each tile stably as
    int32 keys (n < 2^31) and marks each row's tiles in a mask of
    ``mask_words(T)`` 64-bit words a row (rows * ceil(M / 65536) words of
    scratch, zeroed each call), the sum's launch adds each row's runs tile
    by tile.

  Neither reads back to the host, so the form is captured with the layout
  step. This is a size rule, not a fallback: a failed build or launch
  raises;
- ``segment_sum_sorted(out, keys, values, perm=None)``, for ids sorted once
  when their plan or table is built (the block-fold plan's ``block_hub``,
  the scatter plan, the tables' COO overflow rows, the Chebyshev SpMV's
  overflow): ``keys`` ascending, and ``values[perm[i]]`` the i-th term in
  key order (``perm`` None: ``values`` are in key order already); a call
  only sums, by one launch of the static kernel: each row's terms are one
  run of places; on a call without a perm, of 8 columns at most, a run of
  ``LONG_RUN`` or more is streamed by a warp through its shared memory
  while one lane a column adds, and every other run is added by the lane
  at its start. It finds the runs itself (no run table, no host read), so
  it is captured with the layout step.

The kernels (``csrc/segment_sum.cu``) add each row's terms in order in one
thread (one lane a column), from the row's current value, with
``__fadd_rn``. ``segment_sum_reference`` is the sums' plain version, the
CPU's ``index_add_``; ``cluster_walk_reference`` is the cluster kernel's
order (a stable ``torch.sort`` of the whole id list), which
``segment_sum_cluster_reference`` adds term by term; ``sort_tiles_reference``
is the tile sort's, a stable ``torch.sort`` of each tile;
``static_runs_reference`` is the static kernel's table of runs (starts,
ends, which are long). The wrappers run
the plain versions for tensors on the CPU. For CUDA tensors they launch the
kernels or raise: nothing here falls back to ``index_add_``'s atomics or to
``torch.sort``. The CPU tests hold each plain version against
``index_add_``; ``python -m pytest --noconftest -m cuda
tests/test_torch_determinism.py`` on a card and phase 25 of
``chip_smoke.py`` hold each kernel bit-equal to the CPU's ``index_add_``
and to its plain version. ``segment_sum_cluster.launches`` counts the
cluster kernel's launches, ``segment_sum.launches`` the tiled sum's and
the static kernel's and ``sort_tiles.launches`` the tile sort's. Ids
must lie in [0, rows of out); the card does not read them back to check.
"""

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils import tracing

# Terms per tile of the step's ids: one block of the kernel sorts a tile,
# a term a thread.
TILE = 1024
# The key that pads the last tile (the kernel skips it): past any row.
PAD_KEY = 2**31 - 1
# Blocks of a cluster of the cluster kernel, and its most clusters a launch.
CLUSTER_BLOCKS = 16
CLUSTER_GROUPS = 8
# The most terms that one cluster launch sums on an H100 (232,448 bytes of
# shared memory a block): what one cluster holds, 16 blocks of 8,192 keys,
# since all the terms may fall to one cluster's rows. Other cards report
# their own (``cluster_max_terms``).
CLUSTER_MAX_TERMS = 131_072
# The most bits of the row that one radix pass of the cluster kernel sorts
# by.
RADIX_BITS = 10
# Runs of this many keys or more are long in the static kernel (its
# kLongRun, set from a sweep on an H100): a warp streams them where the call
# allows it.
LONG_RUN = 64


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


def static_runs_reference(keys):
    """The static kernel's table of runs of ``keys`` (ascending; a tensor or
    an array): (starts, ends, is_long) int64 and bool numpy arrays, one
    entry a run in key order. A place starts a run where its key differs
    from the one before it; the run ends where the next one starts, and is
    long when it has ``LONG_RUN`` places or more. The kernel streams a long
    run by a warp on a call without a perm, of 8 columns at most and 16-byte
    aligned values; it adds every other run in the lane at its start."""
    keys = np.asarray(keys.cpu() if torch.is_tensor(keys) else keys)
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) if len(
        keys) else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], len(keys)].astype(np.int64)[:len(starts)]
    return starts.astype(np.int64), ends, ends - starts >= LONG_RUN


def segment_sum_reference(out, keys, values, perm=None):
    """Plain version: ``out.index_add_(0, keys, values[perm])`` (the CPU's
    loop adds each row's terms in ascending order)."""
    return out.index_add_(0, keys, values if perm is None else values[perm])


def _kernel_fn():
    fn = _build.load("segment_sum").graphem_segment_sum_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def _static_fn():
    fn = _build.load("segment_sum").graphem_segment_sum_sorted_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def segment_sum_cuda(out, keys, values, perm=None, tiles=1, mask=None):
    """Launch the kernel on CUDA tensors, in place on ``out``; returns
    ``out``. ``keys`` (T * L,) int32 or int64 are ``tiles`` = T tiles of L,
    each sorted ascending (PAD_KEY, or the int64 maximum, pads); tile t's
    position j holds term t * L + perm[t * L + j] (``perm`` int64, or None
    for terms in key order). Several tiles take int32 keys and the tile
    sort's (rows, mask_words(T)) ``mask``: the tiled sum. One tile takes
    the static kernel (``static_runs_reference``). ``values`` (terms, d) or
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
    if d == 0:
        return out
    keys = keys.contiguous()
    values = values.contiguous()
    perm = None if perm is None else perm.contiguous()
    perm_ptr = None if perm is None else perm.data_ptr()
    fn = _kernel_fn() if T > 1 else _static_fn()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        segment_sum.launches += 1
        if T > 1:
            rc = fn(keys.data_ptr(), perm_ptr, mask.data_ptr(), W,
                    values.data_ptr(), out.data_ptr(), T, L, d, stream)
        else:
            rc = fn(keys.data_ptr(), keys.element_size(), perm_ptr,
                    values.data_ptr(), out.data_ptr(), L, d, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def cluster_walk_reference(ids):
    """Plain version of the cluster kernel's order: (rows, terms), the
    stable sort of the whole (M,) id list, so each row's terms form one
    run in ascending term order."""
    return torch.sort(ids, stable=True)


def segment_sum_cluster_reference(out, ids, values):
    """Plain version of the cluster kernel: ``cluster_walk_reference``'s
    order, added term by term onto ``out`` (the CPU's ``index_add_`` adds
    in that order); in place, returns ``out``."""
    rows, terms = cluster_walk_reference(ids)
    return out.index_add_(0, rows, values[terms])


def cluster_rows(rows, groups):
    """(clusters, rows a cluster) of a launch on a card that runs ``groups``
    clusters at once: cluster g sums the rows [g * span, g * span + span)."""
    groups = max(1, min(groups, rows))
    return groups, -(-rows // groups)


def radix_digits(span):
    """(passes, bits a pass) of a cluster's sort of the rows of a range of
    ``span``: as few passes of at most RADIX_BITS as the offsets' bits
    need, and one at least (a pass gathers the cluster's terms), the bits
    spread evenly over them."""
    bits = max(span - 1, 0).bit_length()
    passes = max(1, -(-bits // RADIX_BITS))
    return passes, max(1, -(-bits // passes))


_capacity = {}


def cluster_max_terms(device):
    """The most terms that one cluster launch sums on the CUDA ``device``,
    from the shared memory a block may opt in to there (CLUSTER_MAX_TERMS
    on an H100; 0 where the card cannot run a cluster). The first call on a
    device sets the kernel up there."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    got = _capacity.get(index)
    if got is None:
        fn = _build.load("segment_sum").graphem_segment_cluster_capacity
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        got = fn(index)
        if got < 0:
            raise RuntimeError(f"segment_sum cluster capacity: CUDA error "
                               f"{-got}")
        _capacity[index] = got
    return got


def cluster_groups(device):
    """The clusters a cluster launch may take on the CUDA ``device``: as
    many as run there at once, at most CLUSTER_GROUPS (7 on an H100)."""
    cluster_max_terms(device)
    fn = _build.load("segment_sum").graphem_segment_cluster_groups
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    index = torch.device(device).index
    return fn(torch.cuda.current_device() if index is None else index)


def _cluster_fn():
    fn = _build.load("segment_sum").graphem_segment_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def segment_sum_cluster(out, ids, values):
    """``out.index_add_(0, ids, values)`` by one launch of the cluster
    kernel on CUDA tensors, each row's terms in ascending order; in place,
    returns ``out``. ``ids`` (M,) int32 or int64, 1 <= M <=
    cluster_max_terms; ``values`` (M, d) or (M,) and ``out`` (rows, d) or
    (rows,) float32. Bit-equal to segment_sum_cluster_reference."""
    if not (out.is_cuda and ids.device == out.device
            and values.device == out.device):
        raise ValueError("segment_sum_cluster takes CUDA tensors on one "
                         "device")
    if out.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError(f"segment_sum_cluster takes float32 values and out, "
                        f"got {values.dtype} and {out.dtype}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.ndim != 1:
        raise TypeError(f"segment_sum_cluster takes int32 or int64 ids of one "
                        f"dimension, got {ids.dtype} {tuple(ids.shape)}")
    if (out.ndim not in (1, 2) or values.shape[1:] != out.shape[1:]
            or values.shape[0] != ids.shape[0]):
        raise ValueError(f"ids {tuple(ids.shape)}, values "
                         f"{tuple(values.shape)} and out {tuple(out.shape)} "
                         f"do not match")
    if not out.is_contiguous():
        raise ValueError("segment_sum_cluster adds into a contiguous out")
    M = ids.shape[0]
    d = out.shape[1] if out.ndim == 2 else 1
    if d == 0:
        return out
    most = cluster_max_terms(out.device)
    if not 1 <= M <= most:
        raise ValueError(f"segment_sum_cluster sums 1 to {most} terms on this "
                         f"card, got {M}")
    ids = ids.contiguous()
    values = values.contiguous()
    groups, span = cluster_rows(out.shape[0], cluster_groups(out.device))
    passes, width = radix_digits(span)
    # each block's digit counts, for its cluster (written before read)
    counts = torch.empty(groups * CLUSTER_BLOCKS * 1024, dtype=torch.int32,
                         device=out.device)
    fn = _cluster_fn()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        segment_sum_cluster.launches += 1
        rc = fn(ids.data_ptr(), ids.element_size(), M, groups, span, passes,
                width, values.data_ptr(), out.data_ptr(), d,
                counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum cluster kernel launch failed: CUDA "
                           f"error {rc}")
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
    ascending order, in place; returns ``out``. On a card up to
    ``cluster_max_terms`` terms take one cluster launch
    (``segment_sum_cluster``), more the tile sort and the sum."""
    if out.is_cuda:
        return _card_dynamic(out, ids, values)
    return segment_sum_reference(out, ids, values)


def _card_dynamic(out, ids, values):
    """segment_sum's form on a card, by the number of terms."""
    M = ids.shape[0]
    if M == 0:
        return out
    if M <= cluster_max_terms(out.device):
        return segment_sum_cluster(out, ids, values)
    keys, perm, T, _, mask = sort_tiles(ids, out.shape[0])
    return segment_sum_cuda(out, keys, values, perm, tiles=T, mask=mask)


segment_sum.launches = 0
segment_sum_cluster.launches = 0
sort_tiles.launches = 0
tracing.counts_launches(segment_sum)
tracing.counts_launches(segment_sum_cluster)
tracing.counts_launches(sort_tiles)
