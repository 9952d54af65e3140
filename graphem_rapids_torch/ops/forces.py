"""Force computations for the layout iteration, and the host-side tables.

Counterpart of ``graphem_rapids_tpu/ops/forces.py``, with both ref orders.

Host builders (numpy, with the threaded C helpers of ``native/`` where the
JAX package runs its own; their arrays are equal to the JAX builders' with
``to_device=False``): a dense self-padded neighbor table turns the spring
pass into a gather + row-sum, degree-binned tables over an internal
degree-sorted renumbering cut its padding on skewed graphs, and the surplus
pairs of hub vertices go to a block-fold overflow plan. The same tables
double as the kNN reference factory: slot (v, s) of the gathered neighbor
positions yields edge midpoint (pos[v] + pos[table[v, s]]) / 2 directly.
The step ops walk buckets only: a flat table is the one-bucket case
(``table_buckets``).
Every sort below is stable, so the tables are identical to the JAX ones.
``native=False`` runs the helpers' plain numpy versions instead; both give
the same arrays, dtypes included.

Step ops (torch): the accumulator of ``ops/segment.py`` takes the place of
JAX's ``segment_sum`` and ``.at[].add``. It adds each row's terms in
ascending contribution order, as ``index_add_`` does on the CPU, so a
card's results are the same on every run and bit-equal to the CPU's on the
same inputs. They agree with the JAX package to a tolerance, as XLA sums in
another order.
"""

import numpy as np
import torch

from .. import native as fg
from ..utils import tracing
from .intersect import segments_intersect_2d
from .segment import segment_sum, segment_sum_sorted

EPS = 1e-6

# Padded / non-edge reference slots are pushed to +BIG so their squared
# distance overflows to +inf and the slot is never selected as a neighbor.
REF_PAD_VALUE = 1e30

# Cost of a scattered row relative to a gathered row in the table cost
# models below. The value is the JAX package's, kept so that both packages
# build identical tables from the same edges.
_SCATTER_ROW_COST = 14


# ---------------------------------------------------------------------- #
# host-side builders (numpy)
# ---------------------------------------------------------------------- #

def _optimal_table_cap(deg, n, max_cap=1024):
    """Neighbor-table width minimizing the per-iteration gather cost model.

        cost(C) = n*C + O(C) + 64*H(C) + 14*(O(C)/128 + H(C))

    where O(C) = sum_v max(deg_v - C, 0) and H(C) = |{v : deg_v > C}|.
    """
    max_deg = int(deg.max()) if len(deg) else 1
    hi = int(min(max_deg, max_cap))
    hist = np.bincount(np.minimum(deg, hi), minlength=hi + 2)
    mass = hist * np.arange(hi + 2)
    extra = int((deg[deg > hi] - hi).sum()) if max_deg > hi else 0
    C = np.arange(1, hi + 1)
    n_tail = hist[::-1].cumsum()[::-1]
    m_tail = mass[::-1].cumsum()[::-1]
    H_clip = n_tail[C + 1]
    # vertices clipped into bin hi vanish from H_clip at C == hi; add them
    # back there so the padding/scatter terms see the real hub count
    n_over = int((deg > hi).sum()) if max_deg > hi else 0
    H = H_clip + np.where(C == hi, n_over, 0)
    O = m_tail[C + 1] - C * H_clip + extra
    cost = n * C + O + 64 * H + _SCATTER_ROW_COST * (O // 128 + H)
    return int(C[int(np.argmin(cost))])


def _ref_prefix(lt_deg, rows):
    """Cheapest kNN ref column prefix: rows*C slots + 13 per spilled edge."""
    hi = int(lt_deg.max()) if len(lt_deg) else 0
    best_cost, best_C = None, hi
    for C in range(1, hi + 1):
        over = int(np.maximum(lt_deg - C, 0).sum())
        cost = rows * C + 13 * over
        if best_cost is None or cost < best_cost:
            best_cost, best_C = cost, C
    return best_C


def build_neighbor_table(edges_np, n, cap=None, ref_order="row",
                         ref_budget=None, native=True):
    """Dense (n, D) self-padded neighbor table + overflow.

    Returns a dict of numpy arrays:
      'table'      : (n, D) int32 neighbor ids (self-padded); with
                     ref_order='slot' it is stored transposed, (D, n),
                     under 'table_t'
      'ref_order'  : 'row' or 'slot', the ref space's enumeration
      'overflow'   : (O, 2) int32 (vertex, neighbor) directed pairs
      'n', 'ref_cap': ints
      'ref_edge'   : (n*ref_cap + O2,) int32 edge id per kNN ref slot
      'ref_valid'  : (n*ref_cap,) bool, which table ref slots are i<j edges
      'overflow_lt': (O2, 2) int32 i<j overflow pairs (appended refs)
      'edge_ref'   : (E,) int32 ref slot of each edge
      'overflow_plan': dict or None (build_overflow_plan)

    ``ref_order`` enumerates the table's ref slots: 'row' puts slot (v, s)
    at v*ref_cap + s, 'slot' at s*n + v (the order the slotwise step ops
    below emit their refs in). ``native``: the C helpers' sorts and rank
    scatters (False: their plain versions).
    """
    if ref_order not in ("row", "slot"):
        raise ValueError(f"unknown ref_order: {ref_order!r}")
    if len(edges_np) == 0:
        out = {
            "table": np.zeros((n, 1), np.int32),
            "overflow": np.zeros((0, 2), np.int32),
            "n": n,
            "ref_cap": 1,
            "ref_edge": np.zeros((n,), np.int32),
            "ref_valid": np.zeros((n,), bool),
            "overflow_lt": np.zeros((0, 2), np.int32),
            "edge_ref": np.zeros((0,), np.int32),
            "overflow_plan": None,
            "ref_order": ref_order,
        }
        if ref_order == "slot":
            out["table_t"] = out.pop("table").T
        return out
    with tracing.span("tables.degrees"):
        E = len(edges_np)
        e0 = np.minimum(edges_np[:, 0], edges_np[:, 1]).astype(np.int32)
        e1 = np.maximum(edges_np[:, 0], edges_np[:, 1]).astype(np.int32)
        deg = np.bincount(e0, minlength=n) + np.bincount(e1, minlength=n)
        if cap is None:
            cap = _optimal_table_cap(deg, n)
        cap = max(cap, 1)

    with tracing.span("tables.rows"):
        # Within each row, i<j neighbors come first (the kNN refs are a
        # prefix of the table columns); then the reverse neighbors.
        deg_fwd = np.bincount(e0, minlength=n)
        deg_rev = np.bincount(e1, minlength=n)
        s = fg.radix_argsort(e0, native)
        fwd_start = np.concatenate(
            [[0], np.cumsum(deg_fwd)[:-1]]).astype(np.int32)
        col_fwd = fg.scatter_ranks(s, e0, fwd_start, native)
        r = fg.radix_argsort(e1, native)
        rev_start = np.concatenate(
            [[0], np.cumsum(deg_rev)[:-1]]).astype(np.int32)
        col_rev = fg.scatter_ranks(r, e1, rev_start, native)
        col_rev += deg_fwd[e1].astype(np.int32)

        in_t_fwd = col_fwd < cap
        in_t_rev = col_rev < cap
        table = np.repeat(np.arange(n, dtype=np.int32)[:, None], cap, axis=1)
        table[e0[in_t_fwd], col_fwd[in_t_fwd]] = e1[in_t_fwd]
        table[e1[in_t_rev], col_rev[in_t_rev]] = e0[in_t_rev]

    with tracing.span("tables.overflow"):
        # overflow pairs vertex-sorted, i<j entries first within a vertex
        ov_src = np.concatenate([e0[~in_t_fwd], e1[~in_t_rev]])
        ov_dst = np.concatenate([e1[~in_t_fwd], e0[~in_t_rev]])
        o = fg.radix_argsort(ov_src, native)
        overflow = np.column_stack([ov_src[o], ov_dst[o]])
        overflow_plan = build_overflow_plan(overflow)

    with tracing.span("tables.refs"):
        ref_cap = max(_ref_prefix(deg_fwd.clip(max=cap), n), 1)
        if ref_budget is not None:
            # drop ref columns (cheapest pads first) until slots + spills fit
            m = int(deg_fwd.max()) if n else 0
            h = np.bincount(deg_fwd, minlength=m + 1)
            gt = n - np.cumsum(h)  # gt[c] = #{v: fwd_deg_v > c}
            total = n * ref_cap + int(gt[ref_cap:].sum())
            while total > ref_budget and ref_cap > 1:
                c = ref_cap - 1
                gt_c = int(gt[c]) if c < len(gt) else 0
                if gt_c >= n:
                    break  # the column is all real edges
                total -= n - gt_c
                ref_cap -= 1

        # ref maps follow the (vertex asc, column asc) order of i<j slots
        sel_s = col_fwd[s] < ref_cap
        kt = s[sel_s]
        ko = s[~sel_s]
        slot_edge = np.zeros((n, ref_cap), np.int32)
        ref_valid = np.zeros((n, ref_cap), bool)
        slot_edge[e0[kt], col_fwd[kt]] = kt
        ref_valid[e0[kt], col_fwd[kt]] = True

        overflow_lt = np.column_stack([e0[ko], e1[ko]])
        edge_ref = np.full(E, -1, np.int32)
        if ref_order == "slot":
            edge_ref[kt] = col_fwd[kt] * n + e0[kt]
            slot_edge = np.ascontiguousarray(slot_edge.T)
            ref_valid = np.ascontiguousarray(ref_valid.T)
        else:
            edge_ref[kt] = e0[kt] * ref_cap + col_fwd[kt]
        edge_ref[ko] = n * ref_cap + np.arange(len(ko), dtype=np.int32)
    out = {
        "overflow": overflow,
        "n": n,
        "ref_cap": ref_cap,
        "ref_edge": np.concatenate([slot_edge.reshape(-1), ko]),
        "ref_valid": ref_valid.reshape(-1),
        "overflow_lt": overflow_lt,
        "edge_ref": edge_ref,
        "overflow_plan": overflow_plan,
        "ref_order": ref_order,
    }
    if ref_order == "slot":
        out["table_t"] = np.ascontiguousarray(table.T)
    else:
        out["table"] = table
    return out


def plan_degree_buckets(deg_clipped, max_buckets=8, overhead_rows=4096):
    """Partition vertices into degree buckets minimizing total table rows.

    Exact DP over the distinct clipped-degree values: a bucket covering
    distinct values (v_i..v_j] costs count * v_j + overhead_rows. Returns
    [(count, cap), ...] ascending by cap; one entry means binning buys
    nothing.
    """
    vals, counts = np.unique(deg_clipped, return_counts=True)
    m = len(vals)
    pc = np.concatenate([[0], np.cumsum(counts)]).astype(np.float64)
    best = np.full(m + 1, np.inf)
    best[0] = 0.0
    choice = np.zeros(m + 1, np.int64)
    for j in range(1, m + 1):
        cand = best[:j] + (pc[j] - pc[:j]) * vals[j - 1] + overhead_rows
        i = int(np.argmin(cand))
        best[j], choice[j] = cand[i], i
    buckets = []
    j = m
    while j > 0:
        i = choice[j]
        buckets.append((int(pc[j] - pc[i]), int(vals[j - 1])))
        j = i
    buckets = buckets[::-1]
    while len(buckets) > max_buckets:
        extras = [
            buckets[g][0] * (buckets[g + 1][1] - buckets[g][1]) - overhead_rows
            for g in range(len(buckets) - 1)
        ]
        g = int(np.argmin(extras))
        buckets[g:g + 2] = [(buckets[g][0] + buckets[g + 1][0], buckets[g + 1][1])]
    return buckets


def build_neighbor_table_binned(edges_user, n, overhead_rows=4096,
                                ref_order="row", ref_budget=None,
                                native=True):
    """Degree-binned neighbor tables over an internal vertex renumbering.

    Vertices are stably sorted by table-cap-clipped degree and split into
    plan_degree_buckets groups, each with its own (count_g, cap_g)
    self-padded table; groups are contiguous in the internal numbering, so
    per-bucket spring blocks concatenate without a scatter.

    Returns None when the plan has one bucket, else a dict of numpy
    arrays (internal ids unless noted):
      'perm' (n,) int32 internal -> user id; 'inv_perm' (n,) int32 user ->
      internal; 'edges_int' (E, 2) int32 i<j lexsorted; 'edge_map' (E,)
      int32 user edge -> internal edge; 'edge_user' (E,) int32 internal
      edge -> user edge
      'buckets': [{'start', 'count', 'cap', 'ref_cap', 'ref_offset',
      'table' (count, cap) int32}], and 'overflow', 'overflow_plan',
      'overflow_lt', 'edge_ref', 'ref_edge', 'ref_valid', 'n', 'ref_order'
      as in build_neighbor_table (the ref space is each bucket's
      count_g * ref_cap_g slots in order, then the overflow refs).

    ``ref_order``: 'row' enumerates bucket g's ref slot (v, s) as
    ref_offset_g + p*ref_cap_g + s (p = v - start_g) and stores 'table'
    (count, cap); 'slot' enumerates ref_offset_g + s*count_g + p and
    stores 'table_t' (cap, count).

    ``native``: the C helpers' sorts, relabel, pair permute and rank
    scatter (False: their plain versions). 'perm' and 'edge_user' are int32
    either way, as the JAX package's are with its C helpers built.
    """
    if ref_order not in ("row", "slot"):
        raise ValueError(f"unknown ref_order: {ref_order!r}")
    E = len(edges_user)
    if E == 0:
        return None
    if max(2 * E, n) >= 2**31:
        raise ValueError(
            f"neighbor-table slot space needs int32 indices: "
            f"n={n}, E={E} exceeds 2^31 slots"
        )
    with tracing.span("tables.degrees"):
        deg = (
            np.bincount(edges_user[:, 0].astype(np.int64), minlength=n)
            + np.bincount(edges_user[:, 1].astype(np.int64), minlength=n)
        )
        C_star = _optimal_table_cap(deg, n)
        clipped = np.minimum(deg, C_star)
        spec = plan_degree_buckets(clipped, overhead_rows=overhead_rows)
        if len(spec) == 1:
            return None

    with tracing.span("tables.renumber"):
        perm = fg.radix_argsort(clipped, native)
        inv = np.empty(n, np.int32)
        inv[perm] = np.arange(n, dtype=np.int32)
        e_lo, e_hi = fg.apply_perm_minmax(
            np.asarray(edges_user, np.int32), inv, native)
        # one argsort of unique pack keys lo << bits(n) | hi, the JAX
        # package's
        order = fg.radix_argsort(
            (e_lo.astype(np.uint64) << int(n).bit_length())
            | e_hi.astype(np.uint64), native)
        edges_int, edge_map = fg.permute_pairs(e_lo, e_hi, order, native)
        e0 = edges_int[:, 0].copy()
        e1 = edges_int[:, 1].copy()

    with tracing.span("tables.rows"):
        counts = np.array([c for c, _ in spec], np.int64)
        caps = np.array([cap for _, cap in spec], np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        vcap = np.repeat(caps, counts).astype(np.int32)

        # a row holds its forward (i<j) neighbors first, then the reverse
        # ones
        deg_fwd = np.bincount(e0, minlength=n)
        deg_rev = np.bincount(e1, minlength=n)
        fwd_start = np.concatenate(
            [[0], np.cumsum(deg_fwd)[:-1]]).astype(np.int32)
        col_fwd = np.arange(E, dtype=np.int32) - fwd_start[e0]
        r = fg.radix_argsort(e1, native)
        rev_start = np.concatenate(
            [[0], np.cumsum(deg_rev)[:-1]]).astype(np.int32)
        col_rev = fg.scatter_ranks(r, e1, rev_start, native)
        col_rev += deg_fwd[e1].astype(np.int32)

        slot_off64 = np.concatenate([[0], np.cumsum(vcap, dtype=np.int64)])
        if int(slot_off64[-1]) >= 2**31:
            raise ValueError(
                f"neighbor-table slot space needs int32 indices: "
                f"{int(slot_off64[-1])} slots exceeds 2^31"
            )
        slot_off = slot_off64.astype(np.int32)
        in_t_fwd = col_fwd < vcap[e0]
        in_t_rev = col_rev < vcap[e1]
        flat_table = np.repeat(np.arange(n, dtype=np.int32), vcap)
        flat_table[slot_off[e0[in_t_fwd]] + col_fwd[in_t_fwd]] = e1[in_t_fwd]
        flat_table[slot_off[e1[in_t_rev]] + col_rev[in_t_rev]] = e0[in_t_rev]

    with tracing.span("tables.overflow"):
        ov_src = np.concatenate([e0[~in_t_fwd], e1[~in_t_rev]])
        ov_dst = np.concatenate([e1[~in_t_fwd], e0[~in_t_rev]])
        o = fg.radix_argsort(ov_src, native)
        overflow = np.column_stack([ov_src[o], ov_dst[o]]).astype(np.int32)
        overflow_plan = build_overflow_plan(overflow)

    with tracing.span("tables.refs"):
        # per-bucket kNN ref prefix (same cost model as the flat ref_cap)
        lt_deg = deg_fwd
        ref_caps = np.zeros(len(spec), np.int64)
        for g, (cnt, cap) in enumerate(spec):
            ld = np.minimum(lt_deg[starts[g]:starts[g] + cnt], cap)
            ref_caps[g] = _ref_prefix(ld, cnt) if cnt else 0
        if ref_budget is not None:
            # drop the ref column holding the fewest real edges until the
            # total ref space (slot prefixes + i<j spills) fits the budget
            n_gt = []
            spill0 = 0
            for g, (cnt, cap) in enumerate(spec):
                ld = lt_deg[starts[g]:starts[g] + cnt]
                m = int(ld.max()) if cnt else 0
                h = np.bincount(ld, minlength=m + 1)
                gt = cnt - np.cumsum(h)
                n_gt.append(gt)
                spill0 += int(gt[ref_caps[g]:].sum())
            total = int((counts * ref_caps).sum()) + spill0
            while total > ref_budget:
                best_g, best_d = -1, 0
                for g, (cnt, _cap) in enumerate(spec):
                    if ref_caps[g] == 0:
                        continue
                    c = int(ref_caps[g]) - 1
                    gt_c = int(n_gt[g][c]) if c < len(n_gt[g]) else 0
                    d = cnt - gt_c
                    if d > best_d:
                        best_d, best_g = d, g
                if best_g < 0:
                    break  # every remaining slot is a real edge
                ref_caps[best_g] -= 1
                total -= best_d
        vref = np.repeat(ref_caps, counts).astype(np.int32)
        ref_off = np.concatenate([[0], np.cumsum(counts * ref_caps)])
        R_slots = int(ref_off[-1])

        sel_t = col_fwd < vref[e0]
        posv = (np.arange(n) - np.repeat(starts, counts)).astype(np.int32)
        if ref_order == "slot":
            # slot-major within each bucket:
            # base_g + s*count_g + (v - start_g)
            base = np.repeat(ref_off[:-1], counts).astype(np.int32)
            cntv = np.repeat(counts, counts).astype(np.int32)
            et = e0[sel_t]
            ref_slot = base[et] + col_fwd[sel_t] * cntv[et] + posv[et]
        else:
            ref_row_off = (np.repeat(ref_off[:-1], counts)
                           + posv * vref).astype(np.int32)
            ref_slot = ref_row_off[e0[sel_t]] + col_fwd[sel_t]
        ref_valid = np.zeros(R_slots, bool)
        ref_valid[ref_slot] = True
        slot_ref_edge = np.zeros(R_slots, np.int32)
        eids_fwd = np.arange(E, dtype=np.int32)
        slot_ref_edge[ref_slot] = eids_fwd[sel_t]

        sel_o = ~sel_t
        overflow_lt = np.column_stack([e0[sel_o], e1[sel_o]])
        edge_ref = np.full(E, -1, np.int32)
        edge_ref[sel_t] = ref_slot
        edge_ref[sel_o] = R_slots + np.arange(int(sel_o.sum()),
                                              dtype=np.int32)
        ref_edge = np.concatenate([slot_ref_edge, eids_fwd[sel_o]])

        buckets = []
        for g, (cnt, cap) in enumerate(spec):
            lo, hi = slot_off[starts[g]], slot_off[starts[g] + cnt]
            table = flat_table[lo:hi].reshape(cnt, cap)
            bucket = {
                "start": int(starts[g]),
                "count": int(cnt),
                "cap": int(cap),
                "ref_cap": int(ref_caps[g]),
                "ref_offset": int(ref_off[g]),
            }
            if ref_order == "slot":
                bucket["table_t"] = np.ascontiguousarray(table.T)
            else:
                bucket["table"] = table
            buckets.append(bucket)
    return {
        "perm": perm,
        "inv_perm": inv,
        "edges_int": edges_int,
        "edge_map": edge_map,
        "edge_user": order,
        "buckets": buckets,
        "overflow": overflow,
        "overflow_plan": overflow_plan,
        "overflow_lt": overflow_lt,
        "edge_ref": edge_ref,
        "ref_edge": ref_edge,
        "ref_valid": ref_valid,
        "ref_order": ref_order,
        "n": n,
    }


def table_buckets(nb):
    """The buckets the step ops walk: a binned table's own, or a flat
    table of ``build_neighbor_table`` as the one bucket over all n rows,
    with its 'table' (or 'table_t' in slot order) and ref slots 0 ..
    n*ref_cap. Bucket dicts as build_neighbor_table_binned's."""
    if "buckets" in nb:
        return nb["buckets"]
    key = "table_t" if nb["ref_order"] == "slot" else "table"
    table = nb[key]
    cap = table.shape[0] if key == "table_t" else table.shape[1]
    return [{"start": 0, "count": int(nb["n"]), "cap": int(cap),
             "ref_cap": int(nb["ref_cap"]), "ref_offset": 0, key: table}]


def build_overflow_plan(overflow):
    """Block-fold plan for the neighbor-table overflow scatter.

    Pads each hub's run of (hub, neighbor) pairs to a multiple of a block
    size B with (hub, hub) self-pairs (zero spring force), so block partial
    sums come from a dense reshape-sum and only O/B partials are scattered.
    B is chosen by the same cost model as the JAX package; None when no B
    beats the plain scatter.

    Returns None or a dict: 'pairs' (O', 2) int32, 'block_hub' (O'/B,)
    int32, 'hub_ids' (H,) int32, 'pad_count' (H,) float32, 'block' int.
    """
    n_over = len(overflow)
    if n_over == 0:
        return None
    hub_ids, counts = np.unique(overflow[:, 0], return_counts=True)
    legacy_cost = _SCATTER_ROW_COST * n_over
    best = None
    for B in (8, 32, 128, 512):
        padded = (counts + B - 1) // B * B
        cost = int(padded.sum() - n_over) + _SCATTER_ROW_COST * int(
            padded.sum() // B
        )
        if cost < legacy_cost and (best is None or cost < best[0]):
            best = (cost, B, padded)
    if best is None:
        return None
    _, B, padded = best
    pairs = np.repeat(hub_ids, padded).astype(np.int32)
    pairs = np.stack([pairs, pairs], axis=1)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    hub_of = np.searchsorted(hub_ids, overflow[:, 0])
    # offset within each hub's padded run preserves the original order
    off = np.arange(n_over) - np.concatenate([[0], np.cumsum(counts)[:-1]])[hub_of]
    pairs[starts[hub_of] + off, 1] = overflow[:, 1]
    block_hub = np.repeat(np.arange(len(hub_ids), dtype=np.int32), padded // B)
    return {
        "pairs": pairs,
        "block_hub": block_hub,
        "hub_ids": hub_ids.astype(np.int32),
        "pad_count": (padded - counts).astype(np.float32),
        "block": B,
    }


# ---------------------------------------------------------------------- #
# step ops (torch)
# ---------------------------------------------------------------------- #

def _spring(diff, k_attr, L_min):
    """Hookean force along ``diff`` (..., d): -k (|diff| - L) diff/|diff|."""
    dist = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + EPS
    return (-k_attr * (dist - L_min)) * (diff / dist)


def _overflow_spring(positions, pairs, k_attr, L_min):
    return _spring(positions[pairs[:, 1]] - positions[pairs[:, 0]],
                   k_attr, L_min)


def apply_overflow_plan(forces, positions, plan, k_attr, L_min):
    """Add hub overflow spring forces via the block-fold plan.

    ``plan`` holds 'pairs', 'block_hub', 'hub_ids' as tensors on the
    positions' device and the int 'block'.
    """
    fo = _overflow_spring(positions, plan["pairs"], k_attr, L_min)
    blk = fo.reshape(-1, plan["block"], fo.shape[-1]).sum(dim=1)
    hub = torch.zeros((plan["hub_ids"].shape[0], fo.shape[-1]),
                      dtype=fo.dtype, device=fo.device)
    segment_sum_sorted(hub, plan["block_hub"], blk)  # block_hub ascending
    # hub_ids are distinct: one term per row, no order to fix
    return forces.index_add(0, plan["hub_ids"], hub)


def _apply_table_overflow(forces, positions, overflow_edges, overflow_plan,
                          k_attr, L_min):
    """Shared overflow accumulation for the table spring variants; adds
    into ``forces``, which the callers make fresh."""
    if overflow_plan is not None:
        return apply_overflow_plan(forces, positions, overflow_plan,
                                   k_attr, L_min)
    if overflow_edges is not None and overflow_edges.shape[0] > 0:
        fo = _overflow_spring(positions, overflow_edges, k_attr, L_min)
        # the table builders sort the COO tail by vertex: rows ascend
        return segment_sum_sorted(forces, overflow_edges[:, 0], fo)
    return forces


def join_blocks(blocks):
    """The row blocks joined in order; a lone block is returned as is,
    without a copy (a flat table's one bucket)."""
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)


def spring_forces_nbtable(positions, nb, k_attr, L_min,
                          overflow_edges=None, overflow_plan=None):
    """Spring forces through the dense neighbor table of
    ``build_neighbor_table`` (a gather, then a row sum): for vertex v the
    sum over u in N(v) of -k_attr (|u - v| - L_min) (u - v)/|u - v|, each
    undirected edge seen once from each side. The overflow pairs, as
    spring_forces_binned takes them; arrays on the host are moved to the
    positions' device."""
    def put(a):
        return None if a is None else torch.as_tensor(
            a, device=positions.device)

    if overflow_plan is not None:
        overflow_plan = {k: v if k == "block" else put(v)
                         for k, v in overflow_plan.items()}
    buckets = table_buckets(nb)
    pn_list = [positions[put(g["table"]).long()] for g in buckets]
    return spring_forces_binned(positions, pn_list, buckets, k_attr, L_min,
                                put(overflow_edges), overflow_plan)


def spring_forces_binned(positions, pn_list, buckets, k_attr, L_min,
                         overflow_edges=None, overflow_plan=None):
    """Spring forces over the tables' buckets (table_buckets): JAX's
    spring_forces_binned, and on a flat table's one bucket its flat
    gather form.

    ``pn_list[g] = positions[buckets[g]['table']]``; internal vertex ids
    are bucket-contiguous, so the per-bucket blocks concatenate.
    """
    blocks = []
    for g, pn in zip(buckets, pn_list):
        pv = positions[g["start"]:g["start"] + g["count"]]
        if g["cap"] == 0:
            blocks.append(torch.zeros_like(pv))
            continue
        blocks.append(_spring(pn - pv[:, None, :], k_attr, L_min).sum(dim=1))
    return _apply_table_overflow(join_blocks(blocks), positions,
                                 overflow_edges, overflow_plan, k_attr, L_min)


def masked_slot_midpoints(pv, pn, rc, valid):
    """(rows*rc, d) slot midpoints (pv[v] + pn[v, s]) / 2 over the first
    ``rc`` columns; slots where ``valid`` is False go to REF_PAD_VALUE."""
    d = pn.shape[2]
    mid = (pv[:, None, :] + pn[:, :rc]) * 0.5
    pad = torch.full((), REF_PAD_VALUE, dtype=pv.dtype, device=pv.device)
    return torch.where(valid.reshape(-1)[:, None], mid.reshape(-1, d), pad)


def overflow_midpoints(positions, overflow_lt, active=True):
    """(O2, d) midpoints of the overflow (i<j) edges; all REF_PAD_VALUE
    when not ``active`` (the sharded tier keeps them on one rank only)."""
    mid = (positions[overflow_lt[:, 0]] + positions[overflow_lt[:, 1]]) * 0.5
    if not active:
        mid = torch.full_like(mid, REF_PAD_VALUE)
    return mid


def midpoint_refs_binned(positions, pn_list, buckets, ref_valid,
                         overflow_lt=None):
    """Edge-midpoint kNN refs from the buckets' spring gathers,
    bucket-major, then the overflow midpoints: JAX's midpoint_refs_binned,
    and on a flat table's one bucket its flat gather form."""
    parts = []
    off = 0
    for g, pn in zip(buckets, pn_list):
        rc = min(g["ref_cap"], g["cap"])
        if rc == 0:
            continue
        pv = positions[g["start"]:g["start"] + g["count"]]
        valid = ref_valid[off:off + g["count"] * rc]
        parts.append(masked_slot_midpoints(pv, pn, rc, valid))
        off += g["count"] * rc
    return _concat_refs(parts, positions, overflow_lt)


def _concat_refs(parts, positions, overflow_lt):
    """The ref blocks in order, then the overflow midpoints."""
    if parts:
        refs = join_blocks(parts)
    else:
        refs = positions.new_zeros((0, positions.shape[1]))
    if overflow_lt is not None and overflow_lt.shape[0] > 0:
        refs = torch.cat([refs, overflow_midpoints(positions, overflow_lt)])
    return refs


def spring_refs_binned_slotwise(positions, tables_t, buckets, k_attr, L_min,
                                ref_valid=None, overflow_lt=None,
                                overflow_edges=None, overflow_plan=None,
                                want_refs=True):
    """Spring forces and midpoint refs from slot-major tables.

    Step op of the ``ref_order='slot'`` tables, JAX's
    spring_refs_binned_slotwise, and on a flat table's one bucket its flat
    slotwise form: ``tables_t[g]`` is bucket g's (cap, count) table
    (table_buckets), walked one slot at a time, a (count, d) gather each,
    which feeds the spring sum and, over the first ref_cap_g slots, the
    refs of bucket g's slot s at ref_offset_g + s*count_g + p; then the
    overflow midpoints. Returns (forces, refs); refs is None unless
    ``want_refs``. The same per-slot arithmetic as spring_forces_binned
    and midpoint_refs_binned, in slot-major enumeration.
    """
    blocks = []
    parts = []
    off = 0
    pad = torch.full((), REF_PAD_VALUE, dtype=positions.dtype,
                     device=positions.device)
    for g, tt in zip(buckets, tables_t):
        cnt, cap = g["count"], g["cap"]
        rc = min(g["ref_cap"], cap)
        pv = positions[g["start"]:g["start"] + cnt]
        acc = torch.zeros_like(pv)
        for s in range(cap):
            pn_s = positions[tt[s]]
            acc = acc + _spring(pn_s - pv, k_attr, L_min)
            if want_refs and s < rc:
                v = ref_valid[off + s * cnt:off + (s + 1) * cnt]
                parts.append(torch.where(v[:, None], (pv + pn_s) * 0.5, pad))
        blocks.append(acc)
        off += cnt * rc
    forces = _apply_table_overflow(join_blocks(blocks), positions,
                                   overflow_edges, overflow_plan, k_attr,
                                   L_min)
    refs = _concat_refs(parts, positions, overflow_lt) if want_refs else None
    return forces, refs


def build_scatter_plan(edges_np, n, device=None):
    """Sorted scatter plan for spring_forces: 'perm' (2E,) and 'sorted_ids'
    (2E,) int64 tensors on ``device`` (None: the CUDA card) such that
    ``segment_sum_sorted(out, sorted_ids, values, perm)`` accumulates the
    stacked edge forces [f; -f] onto the vertices in ascending vertex
    order, and the int 'n'. The JAX package's plan, with a stable sort."""
    from ..models.embedder import resolve_device

    dev = resolve_device(device)
    idx = np.concatenate([edges_np[:, 0], edges_np[:, 1]]).astype(np.int64)
    perm = np.argsort(idx, kind="stable")
    return {
        "perm": torch.as_tensor(perm, device=dev),
        "sorted_ids": torch.as_tensor(idx[perm], device=dev),
        "n": int(n),
    }


def spring_forces(positions, edges, k_attr, L_min, scatter_plan=None):
    """Hookean spring attraction along edges, scatter form.

      F_edge = -k_attr * (||p2-p1|| - L_min) * unit(p2-p1)
      forces[e0] += F_edge ; forces[e1] -= F_edge

    ``scatter_plan`` (build_scatter_plan): accumulate in the plan's sorted
    vertex order.
    """
    f = _spring(positions[edges[:, 1]] - positions[edges[:, 0]], k_attr, L_min)
    values = torch.cat([f, -f], dim=0)
    if scatter_plan is not None:
        out = positions.new_zeros((scatter_plan["n"], positions.shape[1]))
        return segment_sum_sorted(out, scatter_plan["sorted_ids"], values,
                                  scatter_plan["perm"])
    ids = torch.cat([edges[:, 0], edges[:, 1]], dim=0)
    return segment_sum(torch.zeros_like(positions), ids, values)


def _repulsion_terms(positions, edges_i, edges_j, weight, k_inter):
    p1 = positions[edges_i[:, 0]]
    p2 = positions[edges_i[:, 1]]
    q1 = positions[edges_j[:, 0]]
    q2 = positions[edges_j[:, 1]]
    inter_mid = (p1 + p2 + q1 + q2) / 4.0

    def repulse(v):
        d = v - inter_mid
        dist = torch.linalg.vector_norm(d, dim=1, keepdim=True) + EPS
        return weight * (k_inter * d / (dist ** 2))

    return torch.cat([repulse(p1), repulse(p2), repulse(q1), repulse(q2)])


def intersection_forces(positions, edges, knn_indices, sampled_indices,
                        k_inter, pair_weight=None, edge_order=None):
    """Inverse-distance repulsion at geometrically intersecting edge pairs.

    The three candidate filters of the reference (i<j, no shared vertex,
    segments intersect) fold into one multiplicative 0/1 weight over the
    fixed (S*k) candidate set. ``pair_weight`` (S*k,), when given, scales
    that weight pair by pair (the JAX package's sharded path masks padded
    candidates with it). ``edge_order`` (E,) is the comparison key for the
    i<j dedup when the engine renumbers edges internally: the internal ->
    user edge-id map, so the dedup compares user ids.
    """
    n = positions.shape[0]
    k = knn_indices.shape[1]
    candidate_i = torch.repeat_interleave(sampled_indices.long(), k)
    candidate_j = knn_indices.reshape(-1).long()
    if edge_order is not None:
        valid = edge_order[candidate_i] < edge_order[candidate_j]
    else:
        valid = candidate_i < candidate_j
    edges_i = edges[candidate_i]
    edges_j = edges[candidate_j]
    share = (
        (edges_i[:, 0] == edges_j[:, 0])
        | (edges_i[:, 0] == edges_j[:, 1])
        | (edges_i[:, 1] == edges_j[:, 0])
        | (edges_i[:, 1] == edges_j[:, 1])
    )
    intersects = segments_intersect_2d(
        positions[edges_i[:, 0]], positions[edges_i[:, 1]],
        positions[edges_j[:, 0]], positions[edges_j[:, 1]],
    )
    weight = (valid & ~share & intersects).to(positions.dtype)[:, None]
    if pair_weight is not None:
        weight = weight * pair_weight[:, None]
    vals = _repulsion_terms(positions, edges_i, edges_j, weight,
                            float(k_inter))
    ids = torch.cat([edges_i[:, 0], edges_i[:, 1], edges_j[:, 0],
                     edges_j[:, 1]])
    out = torch.zeros((n, positions.shape[1]), dtype=positions.dtype,
                      device=positions.device)
    return segment_sum(out, ids, vals)
