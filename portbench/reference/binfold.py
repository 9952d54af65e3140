"""The bin-fold kNN's selection rule, frozen, in plain torch.

The layout's kNN past 32,768 refs on a card is approximate by design: each
ref falls in one of G*128 bins by its flat position p, bin ((p // T) % G)
* 128 + p % 128, each bin keeps its nearest ref (the first in p order on a
tie), and the k nearest of the bins' winners are the neighbours. Past 2^24
refs the refs are cut into equal segments, each a multiple of T, folded
alone and merged by one top-k. This file states that rule again so that
the reference picks the neighbours the rule picks, with distances in the
precision it is given. Padded ref slots (``pad``) are never picked.
"""

import math

import torch

LANES = 128
MAX_REFS = 1 << 24
MIN_G, MAX_G = 24, 64


def params_for(k, recall_target=0.95, T=2048):
    """(T, G): the bins G*128 that give the structural recall target,
    G in [24, 64]."""
    r = min(max(float(recall_target), 0.5), 0.999)
    bins_needed = (k * k) / (2.0 * -math.log(r))
    G = int(min(MAX_G, max(MIN_G, -(-bins_needed // 128))))
    return T, G


def geometry(E, T, G):
    """(G, n_super) of a fold over E refs: G at most the tiles."""
    n_tiles = -(-E // T)
    G = min(G, n_tiles)
    return G, -(-n_tiles // G)


def segments(E, T):
    """(seg, n_seg): one segment up to 2^24 refs, else n_seg equal
    segments of a multiple of T refs each, the last one short."""
    if E <= MAX_REFS:
        return E, 1
    seg_max = (MAX_REFS // T) * T
    n_seg = -(-E // seg_max)
    seg_raw = -(-E // n_seg)
    return -(-seg_raw // T) * T, n_seg


def _fold(queries, refs, pad, T, G, dtype, chunk_tiles):
    """Bins' (values, positions) of one segment: (S, G*128) each."""
    S, d = queries.shape
    E = refs.shape[0]
    G, n_super = geometry(E, T, G)
    C = T // LANES
    bins = G * LANES
    dev = queries.device
    best = torch.full((S, bins), math.inf, dtype=torch.float64, device=dev)
    best_p = torch.full((S, bins), -1, dtype=torch.int64, device=dev)
    q = queries.to(dtype)
    tile = G * T
    lanes = torch.arange(bins, device=dev)
    g_of, lane_of = lanes // LANES, lanes % LANES
    for s0 in range(0, n_super, chunk_tiles):
        s1 = min(n_super, s0 + chunk_tiles)
        a, b = s0 * tile, min(s1 * tile, E)
        m = s1 - s0
        dist = torch.full((S, m * tile), math.inf, dtype=dtype, device=dev)
        if b > a:
            r = refs[a:b].to(dtype)
            part = torch.zeros((S, b - a), dtype=dtype, device=dev)
            for c in range(d):
                diff = q[:, c:c + 1] - r[:, c]
                part += diff * diff
            part[:, pad[a:b]] = math.inf
            dist[:, :b - a] = part
            del part, r
        dist = dist.view(S, m, G, C, LANES).permute(0, 2, 4, 1, 3)
        dist = dist.reshape(S, bins, m * C)
        vals, j = torch.min(dist, dim=2)  # the first minimum in p order
        del dist
        p = a + ((j // C) * G + g_of) * T + (j % C) * LANES + lane_of
        vals = vals.to(torch.float64)
        better = vals < best
        best = torch.where(better, vals, best)
        best_p = torch.where(better, p, best_p)
    return best, best_p


def knn_binfold(queries, refs, pad, k, recall_target=0.95, dtype=None,
                chunk_refs=1 << 19, extra=0):
    """The rule's k neighbours of each query among ``refs`` (ref
    positions ``pad`` never chosen), nearest first, with ``extra`` more
    ranks after them: (positions (S, k + extra) int64, values (S, k +
    extra) float64, and every bin's winner of every segment, (values,
    positions) (S, n_seg * G * 128)). Distances are taken in ``dtype``
    (default float64) from the refs as given."""
    dtype = torch.float64 if dtype is None else dtype
    T, G = params_for(k, recall_target)
    E = refs.shape[0]
    seg, n_seg = segments(E, T)
    kk = k + extra
    bests, best_ps = [], []
    for s in range(n_seg):
        lo, hi = s * seg, min((s + 1) * seg, E)
        Gs, _ = geometry(hi - lo, T, G)
        chunk_tiles = max(1, chunk_refs // (Gs * T))
        best, best_p = _fold(queries, refs[lo:hi], pad[lo:hi], T, G, dtype,
                             chunk_tiles)
        bests.append(best)
        best_ps.append(torch.where(best_p >= 0, best_p + lo, best_p))
    cand_vals = torch.cat(bests, dim=1)
    cand_pos = torch.cat(best_ps, dim=1)
    v, i = torch.topk(cand_vals, kk, dim=1, largest=False, sorted=True)
    return torch.gather(cand_pos, 1, i), v, (cand_vals, cand_pos)
