"""One Independent-Cascade cascade on bit-packed state: a hand-written CUDA
kernel and its plain version.

Counterpart of the ``lax.while_loop`` of
``graphem_rapids_tpu/ops/ic_sim.py`` ``_ic_run_table`` under ``jit``: the
whole cascade of the gather formulation (every step, the frontier test and
the coins) runs as one launch of ``csrc/ic_cascade.cu`` on the card, so
no (n, cap, B) array reaches memory and the host does not wait between
steps.

State. The B Monte-Carlo columns of a vertex are packed into W = ceil(B /
32) int32 words, column b in bit b % 32 of word b // 32 (``pack_columns``,
``unpack_columns``); bits of the last word at b >= B are zero. The cascade
plan is a self-padded in-neighbour table (n, cap) int32 and the above-cap
in-edges sorted by destination: ``ov_src`` (O,) int32 with row starts
``ov_ptr`` (n + 1,) int32.

The step (the semantics of ``_ic_run_table``). At step t, ``hit(v, b)`` is
true when for some slot j < cap, ``frontier(table[v, j], b)`` and
``coin(t, v, j, b)``, or when an overflow in-edge o of v (ov_ptr[v] <= o <
ov_ptr[v + 1]) has ``frontier(ov_src[o], b)`` and ``coin(t, v, cap + o,
b)``. Then ``newly = hit & ~active``, ``active |= newly``, ``frontier =
newly``. The frontier starts as the seed words. The cascade stops after
the first step whose ``newly`` is empty, or after ``max_iters`` steps; a
self pad never activates anyone (v in the frontier means v active).

The coin. One fixed function, shared by the kernel and the plain version:

    coin(t, v, j, b) = philox4x32_10(counter=(r >> 2, j, v, t), key)[r & 3] < thr

with ``r = b mod runs``. ``runs`` is B by default, so every column draws its
own coins; a greedy chunk passes its runs per candidate, so that run r of
every candidate and of the base group draws the same coins (common random
numbers: the difference of two groups' spreads then carries much less of
their noise). ``key`` is one 64-bit Philox key, two 32-bit words held as a (2,) int64
device tensor drawn from the caller's generator (``draw_key``), so the
host never reads it. ``thr = floor(p * 2^32)`` clipped to [0, 2^32]
(``coin_threshold``): p = 0 never fires and p = 1 always fires. The
counter (step, receiving vertex, slot, run) names each coin of a cascade,
so a coin is the same whoever draws it and whenever: both
versions draw only where an attempt can change the result (a frontier bit
at the source and the column not yet active or hit at the receiver), and
get the coins they would get by drawing them all. The coins are not
``jax.random``'s; the two packages agree in distribution.

The push lists. The kernel's steps are frontier-driven
(``csrc/ic_common.cuh``): a step pushes from the vertices with a frontier
word along their push lists, a CSR by source u of the (receiver v, slot j)
pairs whose coin reads u's frontier (``push_lists``; the plan's
``table_push_lists``, built on the card), and turns to the form's dense
pass where the frontier's pairs pass the form's ``DENSE_BETA`` times G
times the dense pass's slots (``table_dense_limit``). The lists are built
once per plan, never per launch; a CUDA call without them raises. The
private ``mode`` argument ("auto", "push" or "dense") forces a mode for
the tests and the smoke run; the result is the same in every mode.

The chunk list. The dense pass hands the overflow rows of at least
LONG_ROW in-edges out to the whole grid in chunks of CHUNK_EDGES in-edges
(``overflow_chunks``, the plan's push lists' fourth member, built with
them by ``table_push_lists``), so that a hub's row is not one warp's
serial walk; shorter rows are walked by their owner.

``ic_cascade_reference`` is the plain version, a Python loop of torch ops
(``cascade_triples``, shared with the scatter form of ``ops/ic_scatter.py``;
one host sync per step). ``ic_cascade`` runs it for tensors on the CPU and
launches the kernel for CUDA tensors, or raises; ``ic_cascade.launches``
counts the kernel's launches.
"""

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils import tracing
from .knn_binfold import kernel_blocks_per_sm

# Philox4x32-10 (Salmon et al., SC'11; Random123): round multipliers and
# the key's Weyl increments.
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
_TWO32 = 1 << 32

# Threads per block of the cascade kernels (csrc/ic_common.cuh kThreads;
# kMinBlocks, 2, of them are resident on an SM).
THREADS = 512
# The wrapper's int32 control buffer: the kernel's control block (the
# 64-bit barrier count, the three vertex lists' 64-bit counters, the step
# count, the dense step count) in the first CTL_WORDS words, the (B,)
# counts after it.
CTL_WORDS = 10
STEPS_WORD = 8
DENSE_STEPS_WORD = 9
# Modes of the kernels' steps (the private ``mode`` argument): "auto"
# pushes a step whose frontier has few pairs behind it (``dense_limit``)
# and takes the dense pass otherwise; "push" and "dense" force one.
MODES = ("auto", "push", "dense")
# The gather form's beta of ``dense_limit``, measured on an H100 (PERF.md):
# its dense pass skips the words whose columns are all active, so it wins
# early as a cascade fills the graph.
DENSE_BETA = 0.025
# (n, W) items of a table walk that one round of the H100's cooperative
# grid covers (264 blocks of 512 threads): a table with no overflow row
# that small takes every step dense in "auto" (``table_dense_limit``).
SMALL_TABLE_ITEMS = 1 << 17
# A dense_limit no step reaches.
_NEVER_DENSE = 1 << 62
# The bits of a byte, for the plain version's packing of its hit flags.
_BYTE_BITS = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8)
# Triples of one sort of the push lists' build: bounds its working set
# (about 40 bytes a triple) whatever the graph.
PUSH_SORT_CHUNK = 1 << 24
# Counters the self triples' runs spread their updates over (see
# ``push_lists``).
SPREAD = 1024
# The dense pass's chunk list (``overflow_chunks``): the overflow rows of
# at least LONG_ROW in-edges, cut into chunks of CHUNK_EDGES in-edges, each
# chunk a warp's work item against one word. CHUNK_EDGES >= LONG_ROW, so a
# plan of O overflow in-edges has at most O // LONG_ROW chunks.
LONG_ROW = 16
CHUNK_EDGES = 1024
# Slots of the plain version's gather per chunk: bounds its working set
# (about 100 bytes per attempted coin) on a card at the 1M-vertex plan.
REF_CHUNK_WORDS = 1 << 20


def coin_threshold(p):
    """``floor(p * 2^32)`` clipped to [0, 2^32]: a coin fires when its
    32-bit draw is below it."""
    thr = int(float(p) * float(_TWO32))
    return min(max(thr, 0), _TWO32)


def draw_key(generator):
    """A (2,) int64 Philox key (two 32-bit words) on the generator's
    device, drawn from ``generator`` without a host sync."""
    return torch.randint(0, _TWO32, (2,), dtype=torch.int64,
                         generator=generator, device=generator.device)


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for an int64 tensor ``a`` in
    [0, 2^32) and a 32-bit constant ``m``, without int64 overflow."""
    x = a * (m & 0xFFFF)            # < 2^48
    y = a * (m >> 16)               # < 2^48
    s = ((y & 0xFFFF) << 16) + x    # < 2^49
    return (y >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0,
    k1): int64 tensors (or ints) holding 32-bit words, broadcast together.
    Returns the four 32-bit output words as int64 tensors."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def coin_fires(t, v, j, b, key, thr):
    """Bool tensor of ``coin(t, v, j, b)`` for int64 tensors v, j, b of
    one shape, step ``t`` (int), key (2,) int64 and threshold ``thr``."""
    lanes = philox4x32_10(b >> 2, j, v, t, key[0], key[1])
    r = torch.stack(lanes, dim=-1).gather(-1, (b & 3)[..., None])[..., 0]
    return r < thr


def pack_columns(mask):
    """(n, B) bool -> (n, ceil(B / 32)) int32 words, column b in bit b % 32
    of word b // 32; the bits past B are zero."""
    n, B = mask.shape
    W = -(-B // 32)
    bits = torch.zeros((n, W * 32), dtype=torch.int64, device=mask.device)
    bits[:, :B] = mask
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.view(n, W, 32) * weights).sum(dim=2)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_columns(words, B):
    """(n, W) int32 words -> (n, B) bool, the inverse of pack_columns."""
    n, W = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(n, W * 32)[:, :B].bool()


def pack_columns_np(mask):
    """pack_columns of a numpy (n, B) bool array, on the host: (n, W)
    int32 words (uploaded with one copy)."""
    n, B = mask.shape
    W = -(-B // 32)
    packed = np.packbits(mask, axis=1, bitorder="little")
    out = np.zeros((n, 4 * W), np.uint8)
    out[:, :packed.shape[1]] = packed
    return out.view("<u4").astype(np.uint32).view(np.int32)


def column_mask_words(B, device):
    """(W,) int32 words with the bits of columns 0..B-1 set, on
    ``device``."""
    return torch.as_tensor(pack_columns_np(np.ones((1, B), bool))[0],
                           device=device)


def check_runs(num_cols, runs):
    """``runs`` (None: ``num_cols``) as an int in [1, num_cols], or
    raises."""
    runs = int(num_cols) if runs is None else int(runs)
    if not 1 <= runs <= int(num_cols):
        raise ValueError(f"runs must lie in [1, num_cols = {num_cols}], got "
                         f"{runs}")
    return runs


def check_packed(name, tensors, seed_words, key, thr, max_iters, num_cols,
                 runs):
    """Raises on what the packed-state contract of both cascade kernels
    (``name``) does not take: ``tensors`` (int32) and the key (int64) on
    the seed words' device, contiguous; (n, W) seed words with W words for
    ``num_cols`` columns; a (2,) key; thr in [0, 2^32]; max_iters >= 0;
    runs in [1, num_cols]."""
    tensors = dict(tensors, seed_words=seed_words, key=key)
    for label, x in tensors.items():
        want = torch.int64 if label == "key" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name}: {label} must be {want}, got {x.dtype}")
        if x.device != seed_words.device:
            raise ValueError(f"{name}: {label} is on {x.device}, the seed "
                             f"words on {seed_words.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if key.shape != (2,):
        raise ValueError(f"{name}: key must be (2,), got {tuple(key.shape)}")
    if int(num_cols) < 1:
        raise ValueError(f"{name}: num_cols must be >= 1, got {num_cols}")
    W = -(-int(num_cols) // 32)
    if seed_words.ndim != 2 or seed_words.shape[0] < 1 or \
            seed_words.shape[1] != W:
        raise ValueError(f"{name}: seed_words must be (n, W) with W = {W} "
                         f"for {num_cols} columns, got "
                         f"{tuple(seed_words.shape)}")
    if not 0 <= int(thr) <= _TWO32:
        raise ValueError(f"{name}: thr must lie in [0, 2^32], got {thr}")
    if int(max_iters) < 0:
        raise ValueError(f"{name}: max_iters must be >= 0, got {max_iters}")
    check_runs(num_cols, runs)


def _check(table, ov_ptr, ov_src, seed_words, key, thr, max_iters,
           num_cols, runs=None, lists=None, mode="auto"):
    """Raises on what neither version takes, and on a CUDA call without
    push lists."""
    check_mode("ic_cascade", mode)
    check_packed("ic_cascade", dict(table=table, ov_ptr=ov_ptr,
                                    ov_src=ov_src),
                 seed_words, key, thr, max_iters, num_cols, runs)
    if table.ndim != 2 or min(table.shape) < 1:
        raise ValueError(f"ic_cascade: table must be (n, cap) with n, cap "
                         f">= 1, got {tuple(table.shape)}")
    n = table.shape[0]
    if ov_ptr.shape != (n + 1,) or ov_src.ndim != 1:
        raise ValueError(f"ic_cascade: ov_ptr must be ({n + 1},) and ov_src "
                         f"1-d, got {tuple(ov_ptr.shape)} and "
                         f"{tuple(ov_src.shape)}")
    if seed_words.shape[0] != n:
        raise ValueError(f"ic_cascade: seed_words must be (n, W) with n = "
                         f"{n} table rows, got {tuple(seed_words.shape)}")
    if lists is not None:
        check_lists("ic_cascade", lists, n, seed_words.device,
                    ov_src.shape[0])
    elif seed_words.is_cuda:
        raise ValueError("ic_cascade: a CUDA cascade needs the plan's push "
                         "lists (table_push_lists, built once per plan)")


def cascade_triples(src, dst, slot, seed_words, key, thr, max_iters,
                    num_cols, runs, chunk, stats=None):
    """The plain cascade over (receiver, slot, source) triples: (active
    (n, W) int32, counts (B,) int32, steps (1,) int32).

    Triple e is (dst[e], slot[e], src[e]), or slot e itself where ``slot``
    is None. Each step gathers the frontier words of the sources,
    ``chunk`` triples at a time, keeps the bits whose column is not yet
    active at the receiver, draws those coins (column b as run b mod
    ``runs``) and ORs the fired ones into ``hit``: the coins that can
    change the result, each a function of (step, receiver, slot, run)
    alone, so the chunking changes nothing.
    A dict ``stats`` receives 'coins', the number of coins drawn,
    'attempted', the number of triples whose source was in the frontier
    (in some column) at some step: those whose receiver must be read,
    'step_pairs', for each step the number of triples whose source was in
    the frontier and is not their receiver: the pairs a push step of the
    kernels walks (the push lists), 'pushed', the number of such triples
    over the whole cascade, each counted once, and 'sources', the number
    of vertices that were in the frontier at some step.
    """
    n, W = seed_words.shape
    dev = seed_words.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    active = seed_words.clone()
    frontier = seed_words
    steps = coins = 0
    step_pairs = []
    tried = None if stats is None else torch.zeros(
        src.shape[0], dtype=torch.bool, device=dev)
    sources = None if stats is None else torch.zeros(
        n, dtype=torch.bool, device=dev)
    for t in range(int(max_iters)):
        if sources is not None:
            sources |= (frontier != 0).any(dim=1)
        hit = torch.zeros(n * W * 32, dtype=torch.bool, device=dev)
        pairs = torch.zeros((), dtype=torch.int64, device=dev)
        for e0 in range(0, src.shape[0], chunk):
            s, d = src[e0:e0 + chunk].long(), dst[e0:e0 + chunk].long()
            fs = frontier[s]
            if tried is not None:
                behind = (fs != 0).any(dim=1)
                tried[e0:e0 + chunk] |= behind
                pairs += (behind & (s != d)).sum()
            g = fs & ~active[d]  # attempts that can change hit
            e, w = torch.nonzero(g, as_tuple=True)
            bits = (g[e, w][:, None] >> shifts) & 1
            k, bit = torch.nonzero(bits, as_tuple=True)
            e, b = e[k], w[k] * 32 + bit
            v = d[e]
            j = e0 + e if slot is None else slot[e0 + e]
            fire = coin_fires(t, v, j, b % runs, key, thr)
            coins += fire.shape[0]
            hit[v[fire] * (W * 32) + b[fire]] = True
        # eight bits to a byte, four little-endian bytes to a word
        byte = (hit.view(-1, 8).to(torch.uint8) * _BYTE_BITS.to(dev)).sum(
            dim=1, dtype=torch.uint8)
        newly = byte.view(torch.int32).view(n, W) & ~active
        active |= newly
        frontier = newly
        steps += 1
        if stats is not None:
            step_pairs.append(int(pairs))
        if not bool(newly.any()):  # one host sync per step
            break
    if stats is not None:
        stats["coins"] = coins
        stats["attempted"] = int(tried.sum())
        stats["pushed"] = int((tried & (src != dst)).sum())
        stats["sources"] = int(sources.sum())
        stats["step_pairs"] = step_pairs
    counts = unpack_columns(active, int(num_cols)).sum(dim=0,
                                                       dtype=torch.int32)
    return active, counts, torch.tensor([steps], dtype=torch.int32,
                                        device=dev)


def table_triples(table, ov_ptr, ov_src):
    """(src, dst, slot) int64: every table slot and overflow in-edge as one
    (receiver v, slot j, source u) triple, j = cap + o for overflow in-edge
    o; the slots row-major, then the overflow list."""
    n, cap = table.shape
    dev = table.device
    O = ov_src.shape[0]
    rows = torch.arange(n, device=dev)
    dst = torch.cat([rows.repeat_interleave(cap), torch.repeat_interleave(
        rows, (ov_ptr[1:] - ov_ptr[:-1]).long(), output_size=O)])
    slot = torch.cat([torch.arange(cap, device=dev).repeat(n),
                      cap + torch.arange(O, device=dev)])
    src = torch.cat([table.reshape(-1).long(), ov_src.long()])
    return src, dst, slot


def ic_cascade_reference(table, ov_ptr, ov_src, seed_words, key, thr,
                         max_iters, num_cols, runs=None, stats=None):
    """Plain PyTorch cascade: (active (n, W) int32, counts (B,) int32,
    steps (1,) int32), as the kernel gives them.

    The ``table_triples`` are run by ``cascade_triples``. A dict ``stats``
    receives what ``cascade_triples`` counts.
    """
    src, dst, slot = table_triples(table, ov_ptr, ov_src)
    return cascade_triples(src, dst, slot, seed_words, key, thr, max_iters,
                           num_cols, check_runs(num_cols, runs),
                           max(1, REF_CHUNK_WORDS // seed_words.shape[1]),
                           stats)


def push_lists(count, n, key_of, pair_of, device):
    """Push lists of ``count`` (receiver, slot, source) triples over n
    vertices: (out_ptr (n + 1,), out_recv (count,), out_slot (count,))
    int32 on ``device``, a CSR by source in triple order (a stable sort by
    source). ``key_of(lo, hi)`` gives the int32 sources of triples lo..hi
    - 1, with n for a triple whose receiver is its source (it can never
    fire): those sort past out_ptr[n], where no row reaches them.
    ``pair_of(idx)`` gives the int32 (receivers, slots) of the int64
    triple indices ``idx``.

    Up to PUSH_SORT_CHUNK triples: one stable int32 sort. Past it, so that
    the working set stays bounded: a count of each source, then per chunk
    a stable sort, each triple placed at its row's next free entry (its
    run's first index found by a search of the sorted chunk, and the
    rows' fill advanced once a run; the runs of key n, which may be
    millions long, add their zeros to SPREAD counters, not to one). No
    step waits on the host. ``push_lists.builds`` counts the builds, each
    the span ``ic.push``."""
    with tracing.span("ic.push"):
        push_lists.builds += 1
        n = int(n)
        verts = torch.arange(n + 1, dtype=torch.int32, device=device)
        if count <= PUSH_SORT_CHUNK:
            key, idx = torch.sort(key_of(0, count), stable=True)
            ptr = torch.searchsorted(key, verts, out_int32=True)
            del key
            return (ptr,) + tuple(pair_of(idx))
        chunks = [(lo, min(count, lo + PUSH_SORT_CHUNK))
                  for lo in range(0, count, PUSH_SORT_CHUNK)]
        spread = torch.arange(PUSH_SORT_CHUNK, device=device) % SPREAD + n + 1
        rows = torch.zeros(n + 1 + SPREAD, dtype=torch.int32, device=device)
        for lo, hi in chunks:
            key = key_of(lo, hi)
            rows.index_add_(0, torch.where(key == n, spread[:hi - lo], key),
                            torch.ones_like(key))
        fill = torch.zeros(n + 1 + SPREAD, dtype=torch.int64, device=device)
        torch.cumsum(rows[:n], 0, out=fill[1:n + 1])  # row starts; n: self
        ptr = fill[:n + 1].to(torch.int32)
        out_recv = torch.empty(count, dtype=torch.int32, device=device)
        out_slot = torch.empty(count, dtype=torch.int32, device=device)
        for lo, hi in chunks:
            key, idx = torch.sort(key_of(lo, hi), stable=True)
            first = torch.searchsorted(key, key)
            at = torch.arange(hi - lo, device=device)
            run = at == first
            k = key.long()
            pos = fill[k] + (at - first)
            out_recv[pos], out_slot[pos] = pair_of(idx + lo)
            ends = torch.searchsorted(key, key, right=True)
            fill.index_add_(0, torch.where(run, k, spread[:hi - lo]),
                            torch.where(run, ends - first, 0))
        return ptr, out_recv, out_slot


push_lists.builds = 0
tracing.counts_launches(push_lists, "builds")


def table_push_lists(table, ov_src, ov_dst, ov_ptr, n_chunks=None):
    """The gather plan's kernel lists: its ``push_lists`` (out_ptr,
    out_recv, out_slot) and, fourth, the dense pass's chunk list of the
    overflow rows with row starts ``ov_ptr`` (``overflow_chunks``, of
    ``n_chunks`` chunks where the caller knows the count). Table slot (v,
    j) holding u is the pair (v, j) in u's row, overflow in-edge o of v
    (``ov_dst[o]`` = v) the pair (v, cap + o); the self pads, and any
    self-loop, drop out. The triples' indices stay below 2^31 (the table
    budget), so their arithmetic is int32."""
    n, cap = table.shape
    dev = table.device
    flat = table.reshape(-1)
    NC, O = flat.shape[0], ov_src.shape[0]

    def key_of(lo, hi):
        parts = []
        if lo < NC:
            t = flat[lo:min(hi, NC)]
            row = torch.arange(lo, min(hi, NC), dtype=torch.int32,
                               device=dev) // cap
            parts.append(torch.where(t == row, n, t))
        if hi > NC:
            a, b = max(lo, NC) - NC, hi - NC
            o = ov_src[a:b]
            parts.append(torch.where(o == ov_dst[a:b], n, o))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def pair_of(idx):
        idx = idx.to(torch.int32)
        recv, slot = idx // cap, idx % cap
        if O:
            over = idx >= NC
            o = (idx - NC).clamp(min=0)
            recv = torch.where(over, ov_dst[o.clamp(max=O - 1)], recv)
            slot = torch.where(over, cap + o, slot)
        return recv, slot

    return push_lists(NC + O, n, key_of, pair_of, dev) + (
        overflow_chunks(ov_ptr, n_chunks),)


def row_chunks(length):
    """Chunks of the overflow rows of ``length`` in-edges (numpy or torch,
    elementwise): ceil(length / CHUNK_EDGES) from LONG_ROW in-edges on, 0
    below."""
    return (length >= LONG_ROW) * ((length + CHUNK_EDGES - 1) // CHUNK_EDGES)


def overflow_chunks(ov_ptr, n_chunks=None):
    """The dense pass's chunk list of the overflow rows with row starts
    ``ov_ptr`` (n + 1,): (C, 2) int32 on its device, each chunk a row v and
    its first in-edge o0, for every row of at least LONG_ROW in-edges cut
    into chunks of CHUNK_EDGES in-edges (the last of a row partial), rows
    and chunks in order; shorter rows have none. ``n_chunks``, the count C
    where the caller knows it, spares the one host read of it (span
    ``ic.chunks``)."""
    with tracing.span("ic.chunks"):
        dev = ov_ptr.device
        ptr = ov_ptr.long()
        per_row = row_chunks(ptr[1:] - ptr[:-1])
        total = int(per_row.sum()) if n_chunks is None else int(n_chunks)
        rows = torch.repeat_interleave(
            torch.arange(per_row.shape[0], device=dev), per_row,
            output_size=total)
        first = torch.cumsum(per_row, 0) - per_row  # each row's first chunk
        rank = torch.arange(total, device=dev) - first[rows]
        return torch.stack([rows, ptr[rows] + rank * CHUNK_EDGES],
                           dim=1).to(torch.int32)


def check_lists(name, lists, n, device, n_over=None):
    """Raises unless ``lists`` is push lists over n vertices on ``device``:
    (n + 1,), (P,) and (P,) int32, contiguous, P below 2^31; with
    ``n_over``, the gather plan's overflow in-edges O, also its chunk list
    (``table_push_lists``' fourth member): (C, 2) int32, contiguous, C at
    most O // LONG_ROW."""
    names = ("out_ptr", "out_recv", "out_slot") + (
        () if n_over is None else ("chunks",))
    if not isinstance(lists, (tuple, list)) or len(lists) != len(names):
        raise ValueError(f"{name}: lists must be ({', '.join(names)})")
    out_ptr, recv, slot = lists[:3]
    for label, x in zip(names, lists):
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {x.dtype}")
        if x.device != torch.device(device):
            raise ValueError(f"{name}: {label} is on {x.device}, the seed "
                             f"words on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if out_ptr.shape != (n + 1,) or recv.ndim != 1 or \
            slot.shape != recv.shape or recv.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: lists must be ({n + 1},), (P,) and (P,) "
                         f"with P < 2^31, got {tuple(out_ptr.shape)}, "
                         f"{tuple(recv.shape)} and {tuple(slot.shape)}")
    if n_over is not None:
        chunks = lists[3]
        if chunks.ndim != 2 or chunks.shape[1] != 2 or \
                chunks.shape[0] > n_over // LONG_ROW:
            raise ValueError(f"{name}: chunks must be (C, 2) with C <= "
                             f"{n_over // LONG_ROW} (O // LONG_ROW), got "
                             f"{tuple(chunks.shape)}")


def check_mode(name, mode):
    """Raises unless ``mode`` is one of MODES."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {MODES}, got {mode!r}")


def group_lanes(W):
    """Lanes of a warp per vertex or pair for W words: min(32, the power
    of two at least W)."""
    return min(32, 1 << max(0, int(W) - 1).bit_length())


def dense_limit(mode, dense_slots, beta, W):
    """The kernels' dense_limit: a step with more pairs behind its frontier
    is dense. "auto": ``beta`` times G (``group_lanes(W)``) times the dense
    pass's ``dense_slots``: the dense passes fall further behind the push
    pass as W grows (the push pass puts G lanes on a pair's words, the
    dense passes a lane on a word's slots or on an edge's words)."""
    if mode == "push":
        return _NEVER_DENSE
    if mode == "dense":
        return -1
    return int(beta * group_lanes(W) * dense_slots)


def table_dense_limit(mode, n, cap, O, W):
    """The gather kernel's dense_limit: ``dense_limit`` over its n * cap + O
    slots, except in "auto" for a table with no overflow row (O = 0) whose
    walk is at most SMALL_TABLE_ITEMS (vertex, word) items: there every
    step is dense, one item a thread, a shorter chain than a push step's
    (measured on a 2,000-vertex greedy chunk; a hub's overflow rows make
    the walk slower than the push, PERF.md)."""
    if mode == "auto" and O == 0 and n * W <= SMALL_TABLE_ITEMS:
        return -1
    return dense_limit(mode, n * cap + O, DENSE_BETA, W)


def _kernel_fn():
    fn = _build.load("ic_cascade").graphem_ic_cascade_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [
        ctypes.c_ulonglong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return fn


def cascade_grid(device, items, lib="ic_cascade"):
    """Blocks of one launch of the cascade kernel ``lib`` for ``items``
    work items (its threads' first stride): the card's resident blocks
    (the cooperative launch's limit), or fewer where the items need
    fewer."""
    per_sm = kernel_blocks_per_sm(lib, f"graphem_{lib}_blocks_per_sm",
                                  device, THREADS)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sm_count * per_sm, -(-items // THREADS)))


def cascade_state(seed_words, num_cols):
    """The kernels' state and scratch for one cascade: active (n, W),
    hits (3, n, W) (a step's hit words in buffer t % 3), lists (7, n)
    (stamps, three lists' vertices and offsets), all uninitialized, and
    ctl (CTL_WORDS + B,) zeroed."""
    n, W = seed_words.shape
    dev = seed_words.device
    return (torch.empty_like(seed_words),
            torch.empty((3, n, W), dtype=torch.int32, device=dev),
            torch.empty((7, n), dtype=torch.int32, device=dev),
            torch.zeros(CTL_WORDS + int(num_cols), dtype=torch.int32,
                        device=dev))


def launch_result(active, ctl, stats):
    """(active, counts, steps) of a launch; ``stats`` (a dict) receives
    'dense_steps', a (1,) int32 device tensor, and 'outcome', the steps,
    the dense steps and the counts as one (2 + B,) int32 view of the
    control words, to read with one copy."""
    if stats is not None:
        stats["dense_steps"] = ctl[DENSE_STEPS_WORD:DENSE_STEPS_WORD + 1]
        stats["outcome"] = ctl[STEPS_WORD:]
    return active, ctl[CTL_WORDS:], ctl[STEPS_WORD:STEPS_WORD + 1]


def frontier_work(active, out_ptr):
    """(sources, pushed) of a finished cascade from its final (n, W)
    active words and its push lists' row starts, a (2,) int64 tensor on
    their device: the vertices active in some column, and the push-list
    pairs in their rows. Where the cascade stopped on an empty frontier
    before its max_iters, a vertex is active exactly when it was in the
    frontier at some step, so these are the plain version's stats
    'sources' and 'pushed' (``cascade_triples``), which the kernels do not
    count."""
    reached = (active != 0).any(dim=1)
    rows = (out_ptr[1:] - out_ptr[:-1]).long()
    return torch.stack([reached.sum(), (rows * reached).sum()])


def ic_cascade_cuda(table, ov_ptr, ov_src, seed_words, key, thr, max_iters,
                    num_cols, runs=None, lists=None, *, mode="auto",
                    stats=None):
    """Launch the cascade kernel; same outputs as ic_cascade_reference.
    ``lists`` are the plan's kernel lists (``build_cascade_plan``'s
    'push': the push lists and the chunk list). ``stats`` also receives
    'chunk_items', the (chunk, word) items of each dense step."""
    check_mode("ic_cascade", mode)
    if lists is None:
        raise ValueError("ic_cascade_cuda needs the plan's push lists")
    if not table.is_cuda:
        raise ValueError("ic_cascade_cuda takes CUDA tensors")
    dev = table.device
    n, cap = table.shape
    W = seed_words.shape[1]
    O = ov_src.shape[0]
    out_ptr, out_recv, out_slot, chunks = lists
    C = chunks.shape[0]
    G = group_lanes(W)
    active, hits, scratch, ctl = cascade_state(seed_words, num_cols)
    nb = cascade_grid(dev, max(n * W + 32 * C * W,
                               (n + out_recv.shape[0]) * G))
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ic_cascade.launches += 1
        rc = fn(table.data_ptr(), ov_ptr.data_ptr(), ov_src.data_ptr(),
                chunks.data_ptr(), out_ptr.data_ptr(), out_recv.data_ptr(),
                out_slot.data_ptr(), seed_words.data_ptr(),
                active.data_ptr(), hits.data_ptr(), scratch.data_ptr(),
                key.data_ptr(), ctl.data_ptr(), n, cap, C, LONG_ROW,
                CHUNK_EDGES, W, int(num_cols), check_runs(num_cols, runs), G,
                int(thr), int(max_iters),
                table_dense_limit(mode, n, cap, O, W), nb, stream)
    if rc != 0:
        raise RuntimeError(f"ic_cascade kernel launch failed: CUDA error "
                           f"{rc}")
    if stats is not None:
        stats["chunk_items"] = C * W
    return launch_result(active, ctl, stats)


def ic_cascade(table, ov_ptr, ov_src, seed_words, key, thr, max_iters,
               num_cols, runs=None, lists=None, *, mode="auto", stats=None):
    """One cascade from the packed seed words: (active (n, W) int32,
    counts (num_cols,) int32, steps (1,) int32), on the tensors' device.
    Column b draws the coins of run b mod ``runs`` (None: num_cols, every
    column its own).

    The kernel for CUDA tensors (one launch, no host sync), which needs the
    plan's kernel ``lists``, the push lists and the chunk list
    (``build_cascade_plan``'s 'push'); the plain version for CPU tensors,
    which needs none.
    ``mode`` (private: "auto", "push" or "dense") forces the kernel's
    steps; the result is the same. A dict ``stats`` receives the kernel's
    'dense_steps' (a device tensor) and 'chunk_items', or what the plain
    version counts.
    """
    _check(table, ov_ptr, ov_src, seed_words, key, thr, max_iters, num_cols,
           runs, lists, mode)
    if table.is_cuda:
        return ic_cascade_cuda(table, ov_ptr, ov_src, seed_words, key, thr,
                               max_iters, num_cols, runs, lists, mode=mode,
                               stats=stats)
    return ic_cascade_reference(table, ov_ptr, ov_src, seed_words, key, thr,
                                max_iters, num_cols, runs, stats)


ic_cascade.launches = 0
tracing.counts_launches(ic_cascade)
