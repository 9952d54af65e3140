"""The layout's kNN ref space, worked out again from the graph.

The bin-fold kNN keeps one candidate a bin, and a ref's bin follows from
its flat position in the ref array. So the reference has to know where
the program puts each edge midpoint: this file holds a frozen copy of the
rules that decide it (the table width's cost model, the degree buckets,
the internal renumbering, the ref prefix of each bucket and the overflow
refs after them), written again in plain numpy and torch. It reads the
graph and nothing the program made.

The result, ``RefSpace``, maps internal edge ids to user edge ids and
ref positions to internal edge ids (-1 for a pad slot).
"""

from dataclasses import dataclass

import numpy as np
import torch

# the scattered row's cost in the table cost model
SCATTER_ROW_COST = 14
# rows a degree bucket costs beyond its slots (the engine's default)
BUCKET_OVERHEAD_ROWS = 4096
MAX_BUCKETS = 8
MAX_TABLE_CAP = 1024
# the bin fold's index bound past which refs are dropped (on a card)
MAX_REFS_SEGMENTED = (1 << 24) * 16


@dataclass
class RefSpace:
    """The ref array's layout, as int64 tensors on one device."""

    n: int
    lo: torch.Tensor         # (E,) internal edges' lower internal vertex
    hi: torch.Tensor         # (E,) and upper
    edge_user: torch.Tensor  # (E,) internal edge -> user edge id
    inv: torch.Tensor        # (n,) user vertex -> internal vertex
    perm: torch.Tensor       # (n,) internal vertex -> user vertex
    ref_edge: torch.Tensor   # (R,) ref position -> internal edge, -1 a pad
    edge_ref: torch.Tensor   # (E,) internal edge -> ref position


def optimal_table_cap(deg, n, max_cap=MAX_TABLE_CAP):
    """The table width that minimises n*C + O(C) + 64*H(C) + 14*(O(C)/128
    + H(C)), O the overflow pairs and H the rows that overflow."""
    deg = np.asarray(deg, np.int64)
    max_deg = int(deg.max()) if len(deg) else 1
    hi = int(min(max_deg, max_cap))
    hist = np.bincount(np.minimum(deg, hi), minlength=hi + 2)
    mass = hist * np.arange(hi + 2)
    extra = int((deg[deg > hi] - hi).sum()) if max_deg > hi else 0
    C = np.arange(1, hi + 1)
    n_tail = hist[::-1].cumsum()[::-1]
    m_tail = mass[::-1].cumsum()[::-1]
    H_clip = n_tail[C + 1]
    n_over = int((deg > hi).sum()) if max_deg > hi else 0
    H = H_clip + np.where(C == hi, n_over, 0)
    O = m_tail[C + 1] - C * H_clip + extra
    cost = n * C + O + 64 * H + SCATTER_ROW_COST * (O // 128 + H)
    return int(C[int(np.argmin(cost))])


def degree_buckets(values, counts, max_buckets=MAX_BUCKETS,
                   overhead_rows=BUCKET_OVERHEAD_ROWS):
    """[(count, cap), ...] ascending: the partition of the distinct
    clipped degrees ``values`` (with ``counts``) that minimises the rows,
    each bucket costing ``overhead_rows`` more; merged down to
    ``max_buckets`` by the least padding."""
    m = len(values)
    pc = np.concatenate([[0], np.cumsum(counts)]).astype(np.float64)
    best = np.full(m + 1, np.inf)
    best[0] = 0.0
    choice = np.zeros(m + 1, np.int64)
    for j in range(1, m + 1):
        cand = best[:j] + (pc[j] - pc[:j]) * values[j - 1] + overhead_rows
        i = int(np.argmin(cand))
        best[j], choice[j] = cand[i], i
    out = []
    j = m
    while j > 0:
        i = choice[j]
        out.append((int(pc[j] - pc[i]), int(values[j - 1])))
        j = i
    out = out[::-1]
    while len(out) > max_buckets:
        extras = [out[g][0] * (out[g + 1][1] - out[g][1]) - overhead_rows
                  for g in range(len(out) - 1)]
        g = int(np.argmin(extras))
        out[g:g + 2] = [(out[g][0] + out[g + 1][0], out[g + 1][1])]
    return out


def ref_prefix(hist, rows):
    """The cheapest ref column count C >= 1 for rows whose clipped forward
    degrees have histogram ``hist``: rows*C slots + 13 per spilled edge,
    the first minimum."""
    hi = len(hist) - 1
    if hi < 1:
        return hi
    d = np.arange(hi + 1)
    best_cost, best_C = None, hi
    for C in range(1, hi + 1):
        over = int((hist * np.maximum(d - C, 0)).sum())
        cost = rows * C + 13 * over
        if best_cost is None or cost < best_cost:
            best_cost, best_C = cost, C
    return best_C


def upper_edges(indptr, indices, device):
    """(e0, e1) int64 tensors: the CSR's i < j entries in row-major order,
    the user's edge ids."""
    indptr = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    cols = torch.as_tensor(np.asarray(indices), device=device).long()
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   indptr[1:] - indptr[:-1],
                                   output_size=cols.shape[0])
    keep = rows < cols
    return rows[keep], cols[keep]


def ref_space(indptr, indices, device, ref_budget=None):
    """The ref array of the layout's fused kNN refs for the CSR graph.

    ``ref_budget``: the most ref positions the program allows (on a card
    MAX_REFS_SEGMENTED - 1; None on the CPU); ref columns are dropped,
    the one with the fewest real edges first, until the space fits.
    """
    e0u, e1u = upper_edges(indptr, indices, device)
    n = len(indptr) - 1
    E = int(e0u.shape[0])
    deg = (torch.bincount(e0u, minlength=n)
           + torch.bincount(e1u, minlength=n)).cpu().numpy()
    C_star = optimal_table_cap(deg, n)
    clipped = np.minimum(deg, C_star)
    counts_by_value = np.bincount(clipped)
    values = np.nonzero(counts_by_value)[0]
    spec = degree_buckets(values, counts_by_value[values])
    ar = torch.arange(n, device=device)
    flat = len(spec) == 1
    if flat:
        # one bucket: the flat table, in the user's numbering
        perm = ar
        spec = [(n, C_star)]
    else:
        perm = torch.sort(torch.as_tensor(clipped, device=device),
                          stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = ar
    a, b = inv[e0u], inv[e1u]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    order = torch.argsort(lo * n + hi)
    lo, hi = lo[order], hi[order]

    counts = np.array([c for c, _ in spec], np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    deg_fwd = torch.bincount(lo, minlength=n)
    fwd_start = torch.cumsum(deg_fwd, 0) - deg_fwd
    col = torch.arange(E, device=device) - fwd_start[lo]

    fwd_np = deg_fwd.cpu().numpy()
    ref_caps = np.zeros(len(spec), np.int64)
    hists = []
    for g, (cnt, cap) in enumerate(spec):
        part = fwd_np[starts[g]:starts[g] + cnt]
        hists.append(np.bincount(part))
        ref_caps[g] = (ref_prefix(np.bincount(np.minimum(part, cap)), cnt)
                       if cnt else 0)
    if flat:
        ref_caps[0] = max(ref_caps[0], 1)
    if ref_budget is not None and flat:
        # the flat table drops its last column while it holds a pad
        gt = n - np.cumsum(hists[0])
        total = n * int(ref_caps[0]) + int(gt[ref_caps[0]:].sum())
        while total > ref_budget and ref_caps[0] > 1:
            c = int(ref_caps[0]) - 1
            gt_c = int(gt[c]) if c < len(gt) else 0
            if gt_c >= n:
                break
            total -= n - gt_c
            ref_caps[0] -= 1
    elif ref_budget is not None:
        # the columns past each prefix are spilled refs
        gts = [cnt - np.cumsum(h) for (cnt, _), h in zip(spec, hists)]
        total = int((counts * ref_caps).sum()) + sum(
            int(gt[ref_caps[g]:].sum()) for g, gt in enumerate(gts))
        while total > ref_budget:
            best_g, best_d = -1, 0
            for g, (cnt, _) in enumerate(spec):
                if ref_caps[g] == 0:
                    continue
                c = int(ref_caps[g]) - 1
                gt_c = int(gts[g][c]) if c < len(gts[g]) else 0
                if cnt - gt_c > best_d:
                    best_d, best_g = cnt - gt_c, g
            if best_g < 0:
                break
            ref_caps[best_g] -= 1
            total -= best_d

    bucket_of = torch.as_tensor(np.repeat(np.arange(len(spec)), counts),
                                device=device)
    ref_caps_t = torch.as_tensor(ref_caps, device=device)
    ref_off = torch.as_tensor(
        np.concatenate([[0], np.cumsum(counts * ref_caps)]), device=device)
    starts_t = torch.as_tensor(starts, device=device)
    vref = ref_caps_t[bucket_of]
    row_off = ref_off[bucket_of] + (ar - starts_t[bucket_of]) * vref
    in_slots = col < vref[lo]
    R_slots = int(ref_off[-1])
    spilled = torch.nonzero(~in_slots).flatten()
    edge_ref = torch.empty(E, dtype=torch.int64, device=device)
    edge_ref[in_slots] = row_off[lo[in_slots]] + col[in_slots]
    edge_ref[spilled] = R_slots + torch.arange(spilled.shape[0],
                                               device=device)
    ref_edge = torch.full((R_slots + spilled.shape[0],), -1,
                          dtype=torch.int64, device=device)
    ref_edge[edge_ref] = torch.arange(E, device=device)
    return RefSpace(n=n, lo=lo, hi=hi, edge_user=order, inv=inv, perm=perm,
                    ref_edge=ref_edge, edge_ref=edge_ref)
