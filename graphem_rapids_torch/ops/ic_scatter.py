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

``ic_scatter_reference`` is the plain version (``cascade_triples`` over the
(dst[e], e, src[e]) triples, edges in chunks). ``ic_scatter`` runs it for
tensors on the CPU and launches the kernel for CUDA tensors, or raises;
``ic_scatter.launches`` counts the kernel's launches.
"""

import ctypes

import torch

from .. import _build
from .ic_cascade import (
    CTL_WORDS,
    REF_CHUNK_WORDS,
    STEPS_WORD,
    cascade_grid,
    cascade_triples,
    check_packed,
    check_runs,
)

# The kernel's indices: 2E and n * W each stay below this.
INDEX_LIMIT = 1 << 31


def _check(src, dst, seed_words, key, thr, max_iters, num_cols, runs=None):
    """Raises on what neither version takes."""
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
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def ic_scatter_cuda(src, dst, seed_words, key, thr, max_iters, num_cols,
                    runs=None):
    """Launch the scatter cascade kernel; same outputs as
    ic_scatter_reference."""
    if not seed_words.is_cuda:
        raise ValueError("ic_scatter_cuda takes CUDA tensors")
    dev = seed_words.device
    n, W = seed_words.shape
    E2 = src.shape[0]
    active = torch.empty_like(seed_words)
    state = torch.empty((2, n, W), dtype=torch.int32, device=dev)
    ctl = torch.zeros(CTL_WORDS + int(num_cols), dtype=torch.int32,
                      device=dev)
    nb = cascade_grid(dev, max(E2, n * W), "ic_scatter")
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ic_scatter.launches += 1
        rc = fn(src.data_ptr(), dst.data_ptr(), seed_words.data_ptr(),
                active.data_ptr(), state[0].data_ptr(), state[1].data_ptr(),
                key.data_ptr(), ctl.data_ptr(), n, E2, W, int(num_cols),
                check_runs(num_cols, runs), int(thr), int(max_iters), nb,
                stream)
    if rc != 0:
        raise RuntimeError(f"ic_scatter kernel launch failed: CUDA error "
                           f"{rc}")
    return active, ctl[CTL_WORDS:], ctl[STEPS_WORD:STEPS_WORD + 1]


def ic_scatter(src, dst, seed_words, key, thr, max_iters, num_cols,
               runs=None):
    """One scatter-form cascade from the packed seed words: (active (n, W)
    int32, counts (num_cols,) int32, steps (1,) int32), on the tensors'
    device. Column b draws the coins of run b mod ``runs`` (None:
    num_cols, every column its own).

    The kernel for CUDA tensors (one launch, no host sync), the plain
    version for CPU tensors. Endpoints must lie in [0, n); neither
    version reads them back to check.
    """
    _check(src, dst, seed_words, key, thr, max_iters, num_cols, runs)
    if seed_words.is_cuda:
        return ic_scatter_cuda(src, dst, seed_words, key, thr, max_iters,
                               num_cols, runs)
    return ic_scatter_reference(src, dst, seed_words, key, thr, max_iters,
                                num_cols, runs)


ic_scatter.launches = 0
