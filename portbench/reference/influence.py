"""The Independent-Cascade spread estimate, in plain torch, from the graph.

Semantics: every run starts with the seeds active and in its frontier. At
step t each frontier vertex u gets one chance to activate each neighbour
v that is not yet active in that run; the chance fires when the coin
(t, v, j, r) does. The newly active vertices are the next frontier, and a
run ends when no vertex is newly active, or after ``max_iters`` steps.
The estimate is the mean over the runs of the active vertices.

The coins are the program's by its stated rule, frozen here:
``philox4x32_10(counter=(r >> 2, j, v, t), key)[r & 3] < floor(p * 2^32)``
for run r, receiver v and slot j, the key two 32-bit words drawn by
``torch.randint(0, 2^32, (2,), int64)`` from a ``torch.Generator`` seeded
with the caller's key on the run's device. Slot j of the edge u -> v is
u's rank among v's neighbours (ascending), while that rank is below the
in-table's width, and past it the width plus the edge's place in the
overflow list, which runs by receiver (the gather form); on a graph whose
table would pass 2^27 slots, j is the directed edge's index in the list
[i -> j for every edge i < j; then j -> i] (the scatter form).
"""

import numpy as np
import torch

from .tables import optimal_table_cap

TABLE_BUDGET_SLOTS = 1 << 27
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
# (edge, run) pairs of one coin pass: bounds the pass's working set
CHUNK = 1 << 24


def threshold(p):
    """floor(p * 2^32) clipped to [0, 2^32]."""
    return min(max(int(float(p) * float(1 << 32)), 0), 1 << 32)


def draw_key(key, device):
    """The two 32-bit key words (int64 tensor) of the caller's int key."""
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=g,
                         device=device)


def _mulhilo(a, m):
    lo_m, hi_m = m & 0xFFFF, m >> 16
    x = a * lo_m
    y = a * hi_m
    s = ((y & 0xFFFF) << 16) + x
    return (y >> 16) + (s >> 32), s & MASK32


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words under the key words (int64
    tensors holding 32-bit values)."""
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def coins(t, v, j, r, key, thr):
    """Bool tensor: whether coin (t, v, j, r) fires."""
    lanes = philox(r >> 2, j, v, torch.full_like(v, t), key[0], key[1])
    word = torch.stack(lanes, dim=-1).gather(-1, (r & 3)[:, None])[:, 0]
    return word < thr


class CascadeGraph:
    """The graph's out-lists with each edge's coin slot, on ``device``."""

    def __init__(self, indptr, indices, device):
        n = len(indptr) - 1
        ptr = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
        nbr = torch.as_tensor(np.asarray(indices, np.int64), device=device)
        deg = ptr[1:] - ptr[:-1]
        row = torch.repeat_interleave(torch.arange(n, device=device), deg,
                                      output_size=nbr.shape[0])
        keep = row != nbr
        # CSR row u lists u's neighbours v ascending: the edge u -> v, and
        # row v lists u at u's rank among v's neighbours
        src, dst = row[keep], nbr[keep]
        deg = torch.bincount(src, minlength=n)
        start = torch.cumsum(deg, 0) - deg
        rank_in_row = torch.arange(src.shape[0], device=device) - start[src]
        deg_np = deg.cpu().numpy()
        cap = max(1, optimal_table_cap(deg_np, n)) if len(src) else 1
        if n * cap <= TABLE_BUDGET_SLOTS:
            # the slot of u -> v is the rank of u in row v: the reverse
            # entry's rank, found by sorting the (dst, src) keys
            rev = torch.argsort(dst * n + src)
            rank_of = torch.empty_like(rank_in_row)
            rank_of[rev] = rank_in_row
            over = torch.clamp(deg - cap, min=0)
            ov_ptr = torch.cumsum(over, 0) - over
            slot = torch.where(rank_of < cap, rank_of,
                               cap + ov_ptr[dst] + rank_of - cap)
            self.form = "gather"
        else:
            # index in [lo -> hi for each edge lo < hi; then hi -> lo]
            up = src < dst
            n_up = int(up.sum())
            upper_id = torch.cumsum(up.long(), 0) - 1
            key = torch.minimum(src, dst) * n + torch.maximum(src, dst)
            order = torch.argsort(key[up])
            ids = torch.searchsorted(key[up][order], key)
            eid = upper_id[up][order][ids]
            slot = torch.where(up, eid, eid + n_up)
            self.form = "scatter"
        self.n, self.cap = n, cap
        self.ptr = torch.cat([start, start[-1:] + deg[-1:]])
        self.src, self.dst, self.slot = src, dst, slot

    def estimate(self, seeds, p, num_sims, max_iters, key, thr=None):
        """(mean spread, counts (num_sims,) int64, steps)."""
        dev = self.src.device
        n, B = self.n, int(num_sims)
        thr = threshold(p) if thr is None else thr
        k = draw_key(key, dev)
        active = torch.zeros((n, B), dtype=torch.bool, device=dev)
        active[torch.as_tensor(np.asarray(seeds, np.int64), device=dev)] = True
        frontier = active.clone()
        runs = torch.arange(B, device=dev)
        steps = 0
        for t in range(int(max_iters)):
            hit = torch.zeros_like(active)
            us = torch.nonzero(frontier.any(dim=1)).flatten()
            lens = self.ptr[us + 1] - self.ptr[us]
            total = int(lens.sum())
            first = torch.repeat_interleave(self.ptr[us], lens,
                                            output_size=total)
            offs = torch.arange(total, device=dev) - torch.repeat_interleave(
                torch.cumsum(lens, 0) - lens, lens, output_size=total)
            edges = first + offs
            for c0 in range(0, total, max(1, CHUNK // B)):
                e = edges[c0:c0 + max(1, CHUNK // B)]
                u, v = self.src[e], self.dst[e]
                tries = frontier[u] & ~active[v]
                ei, b = torch.nonzero(tries, as_tuple=True)
                fire = coins(t, v[ei], self.slot[e][ei], runs[b], k, thr)
                hit[v[ei][fire], b[fire]] = True
            newly = hit & ~active
            active |= newly
            frontier = newly
            steps += 1
            if not bool(newly.any()):
                break
        counts = active.sum(dim=0)
        return float(counts.double().mean()), counts.cpu().numpy(), steps
