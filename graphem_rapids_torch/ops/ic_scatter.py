"""One Independent-Cascade cascade of the scatter formulation on bit-packed
state: a hand-written CUDA kernel and its plain version.

Counterpart of ``graphem_rapids_tpu/ops/ic_sim.py`` ``_ic_run`` under
``jit``, the path both packages take where the gather form's cascade table
would pass ``TABLE_BUDGET_SLOTS``: the whole cascade runs as one launch of
``csrc/ic_scatter.cu`` on the card, over the directed edge list, with no
(num_sims, 2E) coin or attempt array and no host wait between steps.

State is that of ``ops/ic_cascade.py``: (n, W) int32 words, column b of a
vertex in bit b % 32 of word b // 32. The edges are the (2E,) int32 lists
``src = [e0; e1]`` and ``dst = [e1; e0]`` of the undirected list (JAX's
order, ``ic_sim.directed_edges``).

The step (the semantics of JAX's ``_ic_run``). At step t, for each
directed edge e and column b, ``hit(dst[e], b) |= frontier(src[e], b) &
coin(t, dst[e], e, b)``; then ``newly = hit & ~active``, ``active |=
newly``, ``frontier = newly``. The frontier starts as the seed words; the
cascade stops after the first step whose ``newly`` is empty, or after
``max_iters`` steps.

The coin is the gather form's ``coin(t, v, j, b)`` with the directed edge
index as the slot j (column b drawing as run b mod ``runs``), so each coin
is a function of (t, e, b mod runs) and the key alone: the kernel and the
plain version each draw only coins that can change the result, and give
the same active words, counts and steps.

The kernel's steps are ``csrc/ic_common.cuh``'s frontier-driven steps,
shared with the gather form: they push along the push lists of the
directed edges (``edge_push_lists``: edge e is the pair (dst[e], e) in
src[e]'s row), built once per directed list and passed to every launch,
and take the edge sweep as the dense pass where the frontier's pairs
pass ``DENSE_BETA`` times G times 2E (``ic_cascade.dense_limit``). The
private ``mode`` argument forces a mode, as in ``ops/ic_cascade.py``.

``ic_scatter_reference`` is the plain version (``cascade_triples`` over the
(dst[e], e, src[e]) triples, edges in chunks). ``ic_scatter`` runs it for
tensors on the CPU and launches the kernel for CUDA tensors, or raises;
``ic_scatter.launches`` counts the kernel's launches.
"""

import ctypes

import torch

from .. import _build
from ..utils import tracing
from .ic_cascade import (
    REF_CHUNK_WORDS,
    cascade_grid,
    cascade_state,
    cascade_triples,
    check_lists,
    check_mode,
    check_packed,
    check_runs,
    dense_limit,
    group_lanes,
    launch_result,
    push_lists,
)

# The kernel's indices: 2E and n * W each stay below this.
INDEX_LIMIT = 1 << 31
# The scatter form's beta of ``dense_limit``, measured on an H100
# (PERF.md): its dense pass reads every edge whatever is active.
DENSE_BETA = 0.1


def _check(src, dst, seed_words, key, thr, max_iters, num_cols, runs=None,
           lists=None, mode="auto"):
    """Raises on what neither version takes, and on a CUDA call without
    push lists."""
    check_mode("ic_scatter", mode)
    check_packed("ic_scatter", dict(src=src, dst=dst), seed_words, key, thr,
                 max_iters, num_cols, runs)
    if src.ndim != 1 or dst.shape != src.shape:
        raise ValueError(f"ic_scatter: src and dst must be (2E,) alike, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    if src.shape[0] >= INDEX_LIMIT:
        raise ValueError(f"ic_scatter: 2E = {src.shape[0]} directed edges "
                         f"must stay below 2^31")
    if seed_words.numel() >= INDEX_LIMIT:
        raise ValueError(f"ic_scatter: n * W = {seed_words.numel()} words "
                         f"must stay below 2^31")
    if lists is not None:
        check_lists("ic_scatter", lists, seed_words.shape[0],
                    seed_words.device)
    elif seed_words.is_cuda:
        raise ValueError("ic_scatter: a CUDA cascade needs the edges' push "
                         "lists (edge_push_lists, built once per list)")


def edge_push_lists(src, dst, n):
    """``push_lists`` of the (2E,) int32 directed edges over n vertices:
    edge e is the pair (dst[e], e) in src[e]'s row, rows in edge order; a
    self-loop drops out (past out_ptr[n])."""
    def key_of(lo, hi):
        s = src[lo:hi]
        return torch.where(s != dst[lo:hi], s, int(n))

    def pair_of(idx):
        return dst[idx], idx.to(torch.int32)

    return push_lists(src.shape[0], n, key_of, pair_of, src.device)


def ic_scatter_reference(src, dst, seed_words, key, thr, max_iters,
                         num_cols, runs=None, stats=None, chunk=None):
    """Plain PyTorch cascade: (active (n, W) int32, counts (B,) int32,
    steps (1,) int32), as the kernel gives them.

    Directed edge e is the triple (receiver dst[e], slot e, source
    src[e]); ``chunk`` edges are gathered at a time (default: about
    ``REF_CHUNK_WORDS`` words), which bounds the working set on a card
    and changes no result. A dict ``stats`` receives 'coins', the number
    of coins drawn, and 'attempted', the number of edges whose dst[e] a
    cascade must read (src[e] was in the frontier at some step).
    """
    if chunk is None:
        chunk = max(1, REF_CHUNK_WORDS // seed_words.shape[1])
    return cascade_triples(src, dst, None, seed_words, key, thr, max_iters,
                           num_cols, check_runs(num_cols, runs), int(chunk),
                           stats)


def _kernel_fn():
    fn = _build.load("ic_scatter").graphem_ic_scatter_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def ic_scatter_cuda(src, dst, seed_words, key, thr, max_iters, num_cols,
                    runs=None, lists=None, *, mode="auto", stats=None):
    """Launch the scatter cascade kernel; same outputs as
    ic_scatter_reference. ``lists`` are the edges' push lists
    (``edge_push_lists``)."""
    check_mode("ic_scatter", mode)
    if lists is None:
        raise ValueError("ic_scatter_cuda needs the edges' push lists")
    if not seed_words.is_cuda:
        raise ValueError("ic_scatter_cuda takes CUDA tensors")
    dev = seed_words.device
    n, W = seed_words.shape
    E2 = src.shape[0]
    out_ptr, out_recv, out_slot = lists
    G = group_lanes(W)
    active, hits, scratch, ctl = cascade_state(seed_words, num_cols)
    nb = cascade_grid(dev, max(E2, (n + out_recv.shape[0]) * G),
                      "ic_scatter")
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ic_scatter.launches += 1
        rc = fn(src.data_ptr(), dst.data_ptr(), out_ptr.data_ptr(),
                out_recv.data_ptr(), out_slot.data_ptr(),
                seed_words.data_ptr(), active.data_ptr(), hits.data_ptr(),
                scratch.data_ptr(), key.data_ptr(),
                ctl.data_ptr(), n, E2, W, int(num_cols),
                check_runs(num_cols, runs), G, int(thr), int(max_iters),
                dense_limit(mode, E2, DENSE_BETA, W), nb, stream)
    if rc != 0:
        raise RuntimeError(f"ic_scatter kernel launch failed: CUDA error "
                           f"{rc}")
    return launch_result(active, ctl, stats)


def ic_scatter(src, dst, seed_words, key, thr, max_iters, num_cols,
               runs=None, lists=None, *, mode="auto", stats=None):
    """One scatter-form cascade from the packed seed words: (active (n, W)
    int32, counts (num_cols,) int32, steps (1,) int32), on the tensors'
    device. Column b draws the coins of run b mod ``runs`` (None:
    num_cols, every column its own).

    The kernel for CUDA tensors (one launch, no host sync), which needs the
    edges' push ``lists`` (``edge_push_lists``); the plain version for CPU
    tensors, which needs none. ``mode`` (private) and ``stats`` as in
    ``ic_cascade``. Endpoints must lie in [0, n); neither version reads
    them back to check.
    """
    _check(src, dst, seed_words, key, thr, max_iters, num_cols, runs, lists,
           mode)
    if seed_words.is_cuda:
        return ic_scatter_cuda(src, dst, seed_words, key, thr, max_iters,
                               num_cols, runs, lists, mode=mode, stats=stats)
    return ic_scatter_reference(src, dst, seed_words, key, thr, max_iters,
                                num_cols, runs, stats)


ic_scatter.launches = 0
tracing.counts_launches(ic_scatter)
