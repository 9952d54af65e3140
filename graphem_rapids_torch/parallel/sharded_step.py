"""Edge-partitioned layout step over the ranks of a mesh.

Counterpart of ``graphem_rapids_tpu/parallel/sharded_step.py``, both ref
orders. Every rank holds the replicated positions and runs this step; the
work that scales with E is cut by rank:

- spring forces: each rank gathers the neighbor-table rows of its n/ndev
  vertices (every bucket's row shard with the degree-binned tables), then a
  tiled all_gather assembles the (n, d) forces; without a table, a local
  segment sum over the rank's edge shard and an all_reduce. Slot-major
  tables (``ref_order='slot'``) ride transposed and column-sharded: the
  rank gathers its vertices one table slot at a time, a (rows, d) gather
  each, as the single-card slotwise ops do, and its local refs are
  enumerated slot-major (bucket by bucket, s * loc + p; globally
  roff + s * pad + rank * loc + p);
- kNN refs: the rank's edge-midpoint tile, or with fused refs the slot
  midpoints of the same table gather (the overflow refs on rank 0 only);
- kNN: a local top-kk of the replicated query midpoints against the tile,
  merged across ranks by ``knn_comm``: 'all_gather' (gather every rank's
  candidates and re-merge), 'all_to_all' (each rank merges the candidates of
  its S/ndev queries), 'ring' (query shards and running carries rotate
  around the ranks) or 'ring_pallas' (the bin-fold ring of
  parallel/ring_binfold.py: on the cards one launch of the CUDA kernel K3
  per step runs every hop and stores each carry into the right
  neighbour's memory itself);
- intersection repulsion and the standardization are replicated; with
  several ranks, rank 0's new positions are then broadcast. Every sum of
  the step adds in a fixed order (``ops/segment.py``, as XLA does for the
  JAX step, which needs no broadcast), so ranks that hold the same inputs
  compute the same bits, and the broadcast changes nothing then. The
  largest gap it closed, relative to the largest |position|, is kept in
  ``step_ops['replica_gap']``: 0 for ranks in step, while ranks whose
  replicated inputs differ (another sample, other positions) leave it far
  above REPLICA_GAP_LIMIT, which ShardedGraphEmbedder enforces.

Collectives per iteration: one tiled all_gather per spring block (or one
all_reduce), then for the kNN merge two all_gathers ('all_gather'), one
all_to_all pair and one all_gather ('all_to_all'), ndev point-to-point
rotations and one all_gather ('ring'), or one K3 launch, whose carries
travel inside it, and one all_gather ('ring_pallas'), then the positions'
broadcast. Every one of them is a NCCL call (or K3) on the rank's current
stream, with no host wait (``Work.wait()`` of a NCCL work is a stream
wait), so the step can be captured in a CUDA graph and replayed
(ShardedGraphEmbedder.run_layout on the cards).

The local top-k differs from the JAX package's, as the single-card engine's
does: on a CUDA mesh it is the bin-fold kernel K1 when the tile is large
(``use_binfold_local``), otherwise exact in float32 through
``knn_chunked``. bf16 distances were a TPU speed choice ('auto' is float32
here; an explicit ``knn_dtype`` is honored). ``use_approx_local=True`` is
the JAX package's approx local top-k as it runs off a TPU: the tile padded
to a multiple of 128 rows at 1e30, one-shot distances in ``knn_dtype`` (or
the queries' dtype) and an exact ``torch.topk``.
"""

import logging

import numpy as np
import torch

from ..ops import knn_binfold as bf
from ..ops.forces import (
    REF_PAD_VALUE,
    _spring,
    apply_overflow_plan,
    intersection_forces,
    masked_slot_midpoints,
    overflow_midpoints,
)
from ..ops.knn import knn_chunked, squared_distances
from ..ops.sampling import sample_indices
from ..ops.segment import segment_sum, segment_sum_sorted
from .mesh import EDGE_AXIS
from .ring_binfold import check_ring_peers, ring_binfold_topk, \
    ring_supported

logger = logging.getLogger(__name__)

EPS = 1e-6
KNN_COMMS = ("all_gather", "all_to_all", "ring", "ring_pallas")
# Ref tile width of the exact local top-k (knn_chunked): a (S, chunk) f32
# distance block at a time.
LOCAL_CHUNK = 65536
# The bin-fold local top-k takes tiles of at least this many refs.
BINFOLD_LOCAL_MIN_REFS = 4096
# Largest gap between a rank's own positions and rank 0's before the
# broadcast, relative to the largest |position|: 32 float32 ulps. Ranks in
# step leave 0, as every sum of the step adds in a fixed order; ranks whose
# inputs differ leave far more.
REPLICA_GAP_LIMIT = 2.0 ** -18


def pad_edges(edges_np, n_devices):
    """Pad the edge list to a device-divisible length.

    Padded rows are (0, 0) with weight 0: their spring force is identically
    zero and their midpoint is pushed to +LARGE so they can never appear as
    kNN candidates.
    """
    E = len(edges_np)
    E_pad = ((E + n_devices - 1) // n_devices) * n_devices
    edges_p = np.zeros((E_pad, 2), np.int32)
    edges_p[:E] = edges_np
    valid = np.zeros(E_pad, np.float32)
    valid[:E] = 1.0
    return edges_p, valid


def _stable_top(vals, k):
    """Positions of the k smallest values per row, ties to the lower
    column (the order of ``lax.top_k``)."""
    return torch.sort(vals, dim=1, stable=True).indices[:, :k]


def build_sharded_step(mesh, n, E, *, n_components, k_attr, L_min, k_inter,
                       n_neighbors, sample_size, nb=None,
                       knn_recall_target=0.95, use_approx_local=None,
                       use_binfold_local=None, fused_refs=None,
                       knn_comm=None, knn_dtype="auto", packed_gather=None,
                       _debug_knn=False, _debug_spring=False,
                       return_raw=False, axis_name=EDGE_AXIS):
    """Build the layout step of one rank of ``mesh``.

    Returns (step, multi_step, step_ops), plus raw_step when
    ``return_raw``:

    - ``step(positions, edges_padded, valid, generator, step_ops)`` ->
      (positions, generator): one iteration with a sample drawn from the
      ``torch.Generator`` (every rank must hold the same generator state);
    - ``multi_step(..., num_steps)``: ``num_steps`` such iterations (None
      with ``_debug_knn``);
    - ``raw_step(positions, edges_padded, valid, sampled, step_ops)``: one
      iteration with an injected (S,) sample in engine numbering.

    ``edges_padded``/``valid`` come from ``pad_edges`` (replicated, on the
    rank's device); ``step_ops`` holds the graph-shaped tensors and, with
    several ranks, the running ``'replica_gap'`` (a device scalar). ``nb`` is
    the flat or degree-binned neighbor-table dict of ops/forces.py; without
    it the spring pass is the edge-sharded segment sum. ``knn_comm`` is
    one of KNN_COMMS (default 'all_gather'). ``fused_refs=None`` fuses the
    kNN refs into the table gather on CUDA meshes while the padded slot
    count stays within 4E, and keeps the unfused exact path on CPU meshes.
    ``use_binfold_local=None`` takes the bin-fold kernel for the local
    top-k on CUDA meshes with at least BINFOLD_LOCAL_MIN_REFS refs per rank,
    kk <= MAX_K and d <= MAX_DIM; otherwise ``use_approx_local=True``
    takes the one-shot local top-k, and None (as False) the exact chunked
    one. ``knn_dtype='auto'`` is float32;
    ``packed_gather`` is accepted and changes nothing. ``_debug_knn`` makes
    the step return (neighbor edge ids, sample); ``_debug_spring`` returns
    the standardized spring forces. ``axis_name`` is accepted for API
    parity.
    """
    if knn_comm is None:
        knn_comm = "all_gather"
    if knn_comm not in KNN_COMMS:
        raise ValueError(f"Unknown knn_comm: {knn_comm!r}")
    del packed_gather, axis_name
    dev = mesh.device
    n_devices = mesh.world_size
    rank = mesh.rank
    on_cuda = mesh.platform == "cuda"
    E_pad_total = ((E + n_devices - 1) // n_devices) * n_devices
    E_loc = E_pad_total // n_devices
    S = min(sample_size, E)
    k = n_neighbors
    if knn_dtype == "auto":
        knn_dtype = None
    recall_target = float(knn_recall_target)
    kk_probe = min(n_neighbors + 1, max(E // n_devices, 1))
    if use_binfold_local is None:
        use_binfold_local = (
            on_cuda
            and (E // n_devices) >= BINFOLD_LOCAL_MIN_REFS
            and kk_probe <= bf.MAX_K
            and n_components <= bf.MAX_DIM
        )

    def put(a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    def rows(x, loc):
        """This rank's row shard of a replicated tensor."""
        if n_devices == 1:
            return x
        return x[rank * loc:(rank + 1) * loc]

    def cols(x, loc):
        """This rank's column shard of a transposed (slot-major) table."""
        if n_devices == 1:
            return x
        return x[:, rank * loc:(rank + 1) * loc]

    step_ops = {}
    if n_devices > 1:
        step_ops["replica_gap"] = torch.zeros((), device=dev)
    binned = nb is not None and "buckets" in nb
    # slot-major tables ride transposed, (cap, rows), and column-sharded
    slot_order = nb is not None and nb.get("ref_order") == "slot"
    ov_plan = None
    SL = O2 = 0
    if binned:
        # ---- degree-binned tables, bucket-row-sharded ------------------ #
        # Every bucket's table is row-padded to a rank-divisible count and
        # each rank owns 1/ndev of every bucket's rows.
        geoms = []
        for b in nb["buckets"]:
            cnt, cap = int(b["count"]), int(b["cap"])
            rc = min(int(b["ref_cap"]), cap)
            loc = (cnt + n_devices - 1) // n_devices
            geoms.append({
                "start": int(b["start"]), "count": cnt, "cap": cap,
                "rc": rc, "loc": loc, "pad": loc * n_devices,
            })
        btables, bowns = [], []
        for gm, b in zip(geoms, nb["buckets"]):
            if slot_order:
                t = np.asarray(b["table_t"])  # (cap, count): pad columns
                if gm["pad"] != gm["count"]:
                    t = np.concatenate([
                        t, np.full((gm["cap"], gm["pad"] - gm["count"]),
                                   gm["start"], np.int32)
                    ], axis=1)
            else:
                t = np.asarray(b["table"])
                if gm["pad"] != gm["count"]:
                    t = np.concatenate([
                        t, np.full((gm["pad"] - gm["count"], gm["cap"]),
                                   gm["start"], np.int32)
                    ])
            btables.append(put(t))
            # a rank's bucket rows are a contiguous range of positions; an
            # index array is kept only where the padded range would run
            # past n
            if n_devices > 1 and gm["start"] + gm["pad"] > n:
                own = np.full(gm["pad"], gm["start"], np.int32)
                own[:gm["count"]] = np.arange(
                    gm["start"], gm["start"] + gm["count"], dtype=np.int32
                )
                bowns.append(put(own))
            else:
                bowns.append(None)
        step_ops["btables"] = btables
        step_ops["bowns"] = bowns
        ov_plan = nb.get("overflow_plan")
        if ov_plan is not None:
            step_ops["ov_plan"] = {
                "pairs": put(ov_plan["pairs"]),
                "block_hub": put(ov_plan["block_hub"]),
                "hub_ids": put(ov_plan["hub_ids"]),
                "block": int(ov_plan["block"]),
            }
        elif len(nb["overflow"]):
            step_ops["nb_overflow"] = put(nb["overflow"])
        step_ops["edge_order"] = put(nb["edge_user"])

        O2 = int(len(nb["overflow_lt"]))
        n_ref_slots = int(nb["ref_edge"].shape[0])
        if fused_refs is None:
            fused_refs = on_cuda and E > 0 and n_ref_slots <= 4 * E
        if fused_refs:
            # local ref tile: bucket segments of loc_g * rc_g slots (rc_g > 0
            # buckets only), then the overflow block; the global padded ref
            # space has pad_g * rc_g slots per bucket. Slot order enumerates
            # a segment s * loc_g + p (globally roff_g + s * pad_g + p over
            # the padded rows), so its (rc, count) blocks pad columns
            ref_edge_all = np.asarray(nb["ref_edge"])
            ref_valid_all = np.asarray(nb["ref_valid"])
            bref_valid, re_parts = [], []
            # (seg_off_local, seg_len_local, roff_global, loc, pad)
            seg_meta = []
            seg_off = roff = ref_off = 0
            for gm in geoms:
                rc, cnt, loc = gm["rc"], gm["count"], gm["loc"]
                if rc == 0:
                    continue
                z = gm["pad"] - cnt
                if slot_order:
                    rv = ref_valid_all[ref_off:ref_off + cnt * rc].reshape(
                        rc, cnt)
                    re = ref_edge_all[ref_off:ref_off + cnt * rc].reshape(
                        rc, cnt)
                    if z:
                        rv = np.concatenate([rv, np.zeros((rc, z), bool)],
                                            axis=1)
                        re = np.concatenate(
                            [re, np.zeros((rc, z), np.int32)], axis=1)
                else:
                    rv = ref_valid_all[ref_off:ref_off + cnt * rc].reshape(
                        cnt, rc)
                    re = ref_edge_all[ref_off:ref_off + cnt * rc].reshape(
                        cnt, rc)
                    if z:
                        rv = np.concatenate([rv, np.zeros((z, rc), bool)])
                        re = np.concatenate([re, np.zeros((z, rc), np.int32)])
                bref_valid.append(torch.as_tensor(rv, device=dev))
                re_parts.append(re.reshape(-1))
                seg_meta.append((seg_off, loc * rc, roff, loc, gm["pad"]))
                seg_off += loc * rc
                roff += gm["pad"] * rc
                ref_off += cnt * rc
            SL = seg_off          # per-rank slot-ref count
            G_total = roff        # padded global ref-space size
            if SL == 0:
                fused_refs = False  # no i<j ref slots at all
            else:
                step_ops["bref_valid"] = bref_valid
                step_ops["ref_edge_pad"] = put(np.concatenate(
                    re_parts + [ref_edge_all[ref_off:]]
                ))
                if O2:
                    step_ops["overflow_lt"] = put(nb["overflow_lt"])
    elif nb is not None:
        n_loc = (n + n_devices - 1) // n_devices
        n_pad = n_loc * n_devices
        # pad rows (vertices >= n; columns of a slot-major table) gather
        # row 0; the [:n] slice after the all_gather drops their forces
        if slot_order:
            table_t = np.asarray(nb["table_t"])  # (D, n)
            D_tbl = table_t.shape[0]
            if n_pad != n:
                table_t = np.concatenate(
                    [table_t, np.zeros((D_tbl, n_pad - n), np.int32)], axis=1)
            step_ops["table_t_pad"] = put(table_t)
        else:
            table = np.asarray(nb["table"])
            D_tbl = table.shape[1]
            if n_pad != n:
                table = np.concatenate([table, np.zeros((n_pad - n, D_tbl),
                                                        np.int32)])
            step_ops["table_pad"] = put(table)
        step_ops["own_pad"] = put(np.concatenate(
            [np.arange(n, dtype=np.int32), np.zeros(n_pad - n, np.int32)]
        )) if (n_devices > 1 and n_pad != n) else None
        ov_plan = nb.get("overflow_plan")
        if ov_plan is not None:
            step_ops["ov_plan"] = {
                "pairs": put(ov_plan["pairs"]),
                "block_hub": put(ov_plan["block_hub"]),
                "hub_ids": put(ov_plan["hub_ids"]),
                "block": int(ov_plan["block"]),
            }
        elif len(nb["overflow"]):
            step_ops["nb_overflow"] = put(nb["overflow"])

        ref_cap = min(int(nb["ref_cap"]), D_tbl)
        O2 = int(len(nb["overflow_lt"]))
        n_ref_slots = int(nb["ref_edge"].shape[0])
        if fused_refs is None:
            fused_refs = on_cuda and E > 0 and n_ref_slots <= 4 * E
        if fused_refs:
            SL = n_loc * ref_cap  # per-rank slot-ref count
            if slot_order:
                # slot-major refs s * n + v: (ref_cap, n), pad columns; the
                # global padded slot is s * n_pad + v
                rv = np.asarray(nb["ref_valid"][:n * ref_cap]).reshape(
                    ref_cap, n)
                re_slots = np.asarray(nb["ref_edge"][:n * ref_cap]).reshape(
                    ref_cap, n)
                if n_pad != n:
                    rv = np.concatenate(
                        [rv, np.zeros((ref_cap, n_pad - n), bool)], axis=1)
                    re_slots = np.concatenate(
                        [re_slots, np.zeros((ref_cap, n_pad - n), np.int32)],
                        axis=1)
            else:
                rv = np.asarray(nb["ref_valid"]).reshape(n, ref_cap)
                re_slots = np.asarray(nb["ref_edge"][:n * ref_cap]).reshape(
                    n, ref_cap
                )
                if n_pad != n:
                    rv = np.concatenate([rv, np.zeros((n_pad - n, ref_cap),
                                                      bool)])
                    re_slots = np.concatenate(
                        [re_slots, np.zeros((n_pad - n, ref_cap), np.int32)]
                    )
            step_ops["ref_valid_pad"] = torch.as_tensor(rv, device=dev)
            # vertex-pad slots map to edge 0 (they sit at REF_PAD distance);
            # the overflow refs live at [n_pad * ref_cap, +O2)
            step_ops["ref_edge_pad"] = put(np.concatenate(
                [re_slots.reshape(-1), np.asarray(nb["ref_edge"][n * ref_cap:])]
            ))
            if O2:
                step_ops["overflow_lt"] = put(nb["overflow_lt"])
    else:
        fused_refs = False
    fused_refs = bool(fused_refs)

    if knn_comm == "ring_pallas":
        # Build-time geometry probe: tier down to the 'ring' merge, as the
        # JAX package does, where the bin ring's id bound or carry budget
        # refuses the shape.
        R_probe = (SL + O2) if fused_refs else E_loc
        k_merge_probe = min(k + 1, n_devices * min(k + 1, max(R_probe, 1)))
        if not ring_supported(R_probe, S, n_devices, k_merge_probe,
                              recall_target):
            logger.warning(
                "knn_comm='ring_pallas' geometry unsupported "
                "(refs/device=%d, S=%d, ndev=%d, k=%d); tiering down to "
                "knn_comm='ring'", R_probe, S, n_devices, k_merge_probe,
            )
            knn_comm = "ring"
    if knn_comm == "ring_pallas":
        # K3 stores each carry into the right neighbour's card: raises
        # where a neighbour has no peer access (never a silent NCCL path)
        check_ring_peers(mesh)

    def own_rows(positions, ops, g=None):
        """This rank's own vertex rows: of bucket ``g``, or of the flat
        table."""
        if g is None:
            if n_devices == 1:
                return positions
            if ops["own_pad"] is None:
                return positions[rank * n_loc:(rank + 1) * n_loc]
            return positions[rows(ops["own_pad"], n_loc)]
        gm = geoms[g]
        if n_devices == 1:
            return positions[gm["start"]:gm["start"] + gm["count"]]
        if ops["bowns"][g] is None:
            lo = gm["start"] + rank * gm["loc"]
            return positions[lo:lo + gm["loc"]]
        return positions[rows(ops["bowns"][g], gm["loc"])]

    def slot_pass(positions, pv, tt_loc, rv_loc, rc, mids):
        """The spring sum of ``pv``'s rows over the slots of a slot-major
        table shard, one (rows, d) gather per slot; the first ``rc`` slots'
        midpoints (REF_PAD where ``rv_loc`` is False) are appended to
        ``mids`` when ``rv_loc`` is given."""
        acc = torch.zeros_like(pv)
        pad = torch.full((), REF_PAD_VALUE, dtype=pv.dtype, device=pv.device)
        for s in range(tt_loc.shape[0]):
            pn_s = positions[tt_loc[s]]
            acc = acc + _spring(pn_s - pv, k_attr, L_min)
            if rv_loc is not None and s < rc:
                mids.append(torch.where(rv_loc[s][:, None], (pv + pn_s) * 0.5,
                                        pad))
        return acc

    def spring_pass(positions, ops, p1, p2, valid_loc, edges_loc):
        """(spring (n, d), per-bucket (pv, pn), the flat (pv, pn), or with
        slot-major tables the fused refs' midpoint blocks)."""
        d = positions.shape[1]
        if binned and slot_order:
            blocks, mids = [], []
            bidx = 0
            for g, gm in enumerate(geoms):
                if gm["cap"] == 0:
                    blocks.append(positions.new_zeros((gm["count"], d)))
                    continue
                rvg = None
                if fused_refs and gm["rc"] > 0:
                    rvg = cols(ops["bref_valid"][bidx], gm["loc"])
                    bidx += 1
                acc = slot_pass(positions, own_rows(positions, ops, g),
                                cols(ops["btables"][g], gm["loc"]), rvg,
                                gm["rc"], mids)
                blocks.append(mesh.all_gather_tiled(acc)[:gm["count"]])
            spring = torch.cat(blocks, dim=0)
            gathered = mids
        elif slot_order and nb is not None:
            mids = []
            rv_loc = cols(ops["ref_valid_pad"], n_loc) if fused_refs else None
            acc = slot_pass(positions, own_rows(positions, ops),
                            cols(ops["table_t_pad"], n_loc), rv_loc, ref_cap,
                            mids)
            spring = mesh.all_gather_tiled(acc)[:n]
            gathered = mids
        elif binned:
            blocks, gathered = [], []
            for g, gm in enumerate(geoms):
                png = positions[rows(ops["btables"][g], gm["loc"])]
                pvg = own_rows(positions, ops, g)
                gathered.append((pvg, png))
                if gm["cap"] == 0:
                    # isolated vertices: zero spring force, no collective
                    blocks.append(positions.new_zeros((gm["count"], d)))
                    continue
                fvg = _spring(png - pvg[:, None, :], k_attr, L_min).sum(dim=1)
                blocks.append(mesh.all_gather_tiled(fvg)[:gm["count"]])
            spring = torch.cat(blocks, dim=0)
        elif nb is not None:
            pn = positions[rows(ops["table_pad"], n_loc)]  # (n_loc, D, d)
            pv = own_rows(positions, ops)
            spring_loc = _spring(pn - pv[:, None, :], k_attr, L_min).sum(dim=1)
            spring = mesh.all_gather_tiled(spring_loc)[:n]
            gathered = (pv, pn)
        else:
            # edge-sharded segment sum + all_reduce
            f = _spring(p2 - p1, k_attr, L_min) * valid_loc[:, None]
            vals = torch.cat([f, -f], dim=0)
            ids = torch.cat([edges_loc[:, 0], edges_loc[:, 1]])
            spring = mesh.all_reduce(
                segment_sum(torch.zeros_like(positions), ids, vals)
            )
            return spring, None
        if "ov_plan" in ops:
            spring = apply_overflow_plan(spring, positions, ops["ov_plan"],
                                         k_attr, L_min)
        elif "nb_overflow" in ops:
            ovf = ops["nb_overflow"]
            fo = _spring(positions[ovf[:, 1]] - positions[ovf[:, 0]], k_attr,
                         L_min)
            # the table builders sort the COO tail by vertex: rows ascend
            spring = segment_sum_sorted(spring, ovf[:, 0], fo)
        return spring, gathered

    def ref_tile(positions, ops, gathered, p1, p2, valid_loc):
        """This rank's kNN ref tile (R_loc, d)."""
        if fused_refs and slot_order:
            mid_loc = torch.cat(gathered, dim=0)  # the slot pass's blocks
        elif fused_refs and binned:
            mids = []
            for g, gm in enumerate(geoms):
                if gm["rc"] == 0:
                    continue
                rvg = rows(ops["bref_valid"][len(mids)], gm["loc"])
                pvg, png = gathered[g]
                mids.append(masked_slot_midpoints(pvg, png, gm["rc"], rvg))
            mid_loc = torch.cat(mids, dim=0)
        elif fused_refs:
            pv, pn = gathered
            rv_loc = rows(ops["ref_valid_pad"], n_loc)
            mid_loc = masked_slot_midpoints(pv, pn, ref_cap, rv_loc)
        else:
            mid_loc = (p1 + p2) / 2.0
            return torch.where(valid_loc[:, None] > 0, mid_loc,
                               torch.full_like(mid_loc, 1e30))
        if O2:
            # the overflow refs appear once in the merged pool: on rank 0
            mid_loc = torch.cat([
                mid_loc,
                overflow_midpoints(positions, ops["overflow_lt"],
                                   active=rank == 0),
            ])
        return mid_loc

    def to_global(idx_t, owner):
        """Tile-local ref positions of rank ``owner``'s tile -> the global
        ref space (``owner`` an int or a tensor like ``idx_t``)."""
        if fused_refs and binned:
            idx_glob = idx_t - SL + G_total  # the overflow block
            for seg_off_g, seg_len_g, roff_g, loc_g, pad_g in seg_meta:
                in_seg = (idx_t >= seg_off_g) & (idx_t < seg_off_g + seg_len_g)
                if slot_order:
                    u = idx_t - seg_off_g
                    cand = (roff_g + torch.div(u, loc_g, rounding_mode="floor")
                            * pad_g + owner * loc_g + u % loc_g)
                else:
                    cand = idx_t - seg_off_g + roff_g + owner * seg_len_g
                idx_glob = torch.where(in_seg, cand, idx_glob)
            return idx_glob
        if fused_refs and slot_order:
            return torch.where(
                idx_t < SL,
                torch.div(idx_t, n_loc, rounding_mode="floor") * n_pad
                + owner * n_loc + idx_t % n_loc,
                idx_t - SL + n_pad * ref_cap)
        if fused_refs:
            return torch.where(idx_t < SL, idx_t + owner * SL,
                               idx_t - SL + n_pad * ref_cap)
        return idx_t + owner * E_loc

    def body(positions, edges_full, valid_full, sampled, ops):
        edges_loc = rows(edges_full, E_loc)
        valid_loc = rows(valid_full, E_loc)
        p1 = p2 = None
        if not fused_refs:
            p1 = positions[edges_loc[:, 0]]
            p2 = positions[edges_loc[:, 1]]
        spring, gathered = spring_pass(positions, ops, p1, p2, valid_loc,
                                       edges_loc)
        if _debug_spring:
            s0 = spring - spring.mean(dim=0, keepdim=True)
            return s0 / (s0.std(dim=0, keepdim=True, unbiased=True) + EPS)

        sampled = sampled.long()
        q_edges = edges_full[sampled]
        q_mid = (positions[q_edges[:, 0]] + positions[q_edges[:, 1]]) / 2.0
        mid_loc = ref_tile(positions, ops, gathered, p1, p2, valid_loc)
        R_loc = mid_loc.shape[0]
        kk = min(k + 1, R_loc)
        if use_approx_local and not use_binfold_local:
            # the JAX tier's lane pad: rows at 1e30 are never selected
            R_lane = -(-R_loc // 128) * 128
            if R_lane != R_loc:
                mid_loc = torch.cat([mid_loc, mid_loc.new_full(
                    (R_lane - R_loc, mid_loc.shape[1]), 1e30)])

        def tile_topk(queries):
            """Local top-kk of ``queries`` against this rank's tile."""
            if use_binfold_local:
                idx_t, vals_t = bf.knn_binfold(
                    queries.to(torch.float32), mid_loc, kk,
                    recall_target=recall_target,
                )
                idx_t = torch.clamp(idx_t, max=R_loc - 1)
            elif use_approx_local:
                dt = knn_dtype if knn_dtype is not None else queries.dtype
                d2 = squared_distances(queries.to(dt), mid_loc.to(dt))
                vals_t, idx_t = torch.topk(d2, kk, dim=1, largest=False,
                                           sorted=True)
                idx_t = torch.clamp(idx_t, max=R_loc - 1)
            elif knn_dtype is not None:
                idx_t, vals_t = knn_chunked(
                    queries.to(knn_dtype), mid_loc.to(knn_dtype), kk,
                    LOCAL_CHUNK,
                )
            else:
                idx_t, vals_t = knn_chunked(queries, mid_loc, kk, LOCAL_CHUNK)
            return vals_t, idx_t.long()

        # the merged pool can be narrower than k+1 on tiny shards
        k_merge = min(k + 1, n_devices * kk)
        if knn_comm == "ring_pallas":
            _, idx_g, R_pad_ring = ring_binfold_topk(
                q_mid, mid_loc, k_merge, mesh=mesh,
                recall_target=recall_target,
            )
            idx_g = idx_g.long()
            ring_dev = idx_g // R_pad_ring
            ring_p = torch.clamp(idx_g % R_pad_ring, max=R_loc - 1)
            knn_idx = to_global(ring_p, ring_dev)[:, 1:]
        elif knn_comm == "ring":
            # query shards and their running top-k carries rotate left; the
            # carry is ordered by (distance, column key), the column key
            # being the candidate's column in the all_gather merge's
            # (rank, position) layout, so the result equals that merge's
            S_loc = -(-S // n_devices)
            S_pad = S_loc * n_devices
            q_pad = torch.cat([
                q_mid, torch.full((S_pad - S, q_mid.shape[1]), 1e30,
                                  dtype=q_mid.dtype, device=dev),
            ]) if S_pad != S else q_mid
            q_sh = q_pad[rank * S_loc:(rank + 1) * S_loc].contiguous()
            val_dtype = knn_dtype if knn_dtype is not None else q_mid.dtype
            vals_c = torch.full((S_loc, k_merge), float("inf"),
                                dtype=val_dtype, device=dev)
            col_c = torch.full((S_loc, k_merge), torch.iinfo(torch.int32).max,
                               dtype=torch.int32, device=dev)
            idx_c = torch.zeros((S_loc, k_merge), dtype=torch.int32,
                                device=dev)
            col_t = (rank * kk + torch.arange(kk, dtype=torch.int32,
                                              device=dev)).expand(S_loc, kk)
            for _ in range(n_devices):
                v_t, il_t = tile_topk(q_sh)
                i_t = to_global(il_t, rank).to(torch.int32)
                vc = torch.cat([vals_c, v_t.to(val_dtype)], dim=1)
                cc = torch.cat([col_c, col_t], dim=1)
                ic = torch.cat([idx_c, i_t], dim=1)
                o = torch.sort(cc, dim=1, stable=True).indices
                o = torch.gather(o, 1, torch.sort(
                    torch.gather(vc, 1, o), dim=1, stable=True
                ).indices)[:, :k_merge]
                state = [q_sh, torch.gather(vc, 1, o).contiguous(),
                         torch.gather(cc, 1, o).contiguous(),
                         torch.gather(ic, 1, o).contiguous()]
                if n_devices > 1:
                    recv = [torch.empty_like(t) for t in state]
                    for w in mesh.send_recv(state, recv,
                                            dst=(rank - 1) % n_devices,
                                            src=(rank + 1) % n_devices):
                        w.wait()
                    state = recv
                q_sh, vals_c, col_c, idx_c = state
            # after ndev rotations every shard is home, fully merged
            idx_all = mesh.all_gather(idx_c[:, 1:].contiguous())
            knn_idx = idx_all.reshape(S_pad, k_merge - 1)[:S].long()
        elif knn_comm == "all_to_all":
            vals_loc, idx_loc = tile_topk(q_mid)
            idx_glob = to_global(idx_loc, rank)
            S_loc = -(-S // n_devices)
            S_pad = S_loc * n_devices
            if S_pad != S:
                vals_loc = torch.cat([vals_loc, torch.full(
                    (S_pad - S, kk), float("inf"), dtype=vals_loc.dtype,
                    device=dev)])
                idx_glob = torch.cat([idx_glob, torch.zeros(
                    (S_pad - S, kk), dtype=idx_glob.dtype, device=dev)])
            # (source rank, S_loc, kk) candidates of this rank's shard
            vals_x = mesh.all_to_all(vals_loc.reshape(n_devices, S_loc, kk))
            idx_x = mesh.all_to_all(idx_glob.reshape(n_devices, S_loc, kk))
            vals_m = vals_x.transpose(0, 1).reshape(S_loc, n_devices * kk)
            idx_m = idx_x.transpose(0, 1).reshape(S_loc, n_devices * kk)
            pos2 = _stable_top(vals_m, k_merge)
            knn_loc = torch.gather(idx_m, 1, pos2)[:, 1:].contiguous()
            knn_all = mesh.all_gather(knn_loc)
            knn_idx = knn_all.reshape(S_pad, k_merge - 1)[:S]
        else:
            vals_loc, idx_loc = tile_topk(q_mid)
            idx_glob = to_global(idx_loc, rank)
            vals_g = mesh.all_gather(vals_loc)  # (ndev, S, kk)
            idx_g = mesh.all_gather(idx_glob)
            vals_m = vals_g.transpose(0, 1).reshape(S, n_devices * kk)
            idx_m = idx_g.transpose(0, 1).reshape(S, n_devices * kk)
            pos2 = _stable_top(vals_m, k_merge)
            knn_idx = torch.gather(idx_m, 1, pos2)[:, 1:]
        if fused_refs:
            knn_idx = ops["ref_edge_pad"][knn_idx]  # ref slots -> edge ids

        if _debug_knn:
            return knn_idx, sampled

        if knn_idx.shape[1] > 0:
            inter = intersection_forces(
                positions, edges_full, knn_idx, sampled, k_inter,
                edge_order=ops.get("edge_order"),
            )
        else:
            inter = torch.zeros_like(positions)
        new_positions = positions + spring + inter
        new_positions = new_positions - new_positions.mean(dim=0, keepdim=True)
        std = new_positions.std(dim=0, keepdim=True, unbiased=True) + EPS
        new_positions = new_positions / std
        if n_devices > 1:
            # rank 0's positions become every rank's, and the gap they
            # closed is kept: 0 while the ranks' replicated inputs agree
            mine = new_positions.clone()
            mesh.broadcast(new_positions, src=0)
            gap = (mine - new_positions).abs().max() / \
                new_positions.abs().max()
            torch.maximum(ops["replica_gap"], gap, out=ops["replica_gap"])
        return new_positions

    def step(positions, edges_padded, valid, generator, ops):
        sampled = sample_indices(generator, E, S, device=dev)
        return body(positions, edges_padded, valid, sampled, ops), generator

    def multi_step(positions, edges_padded, valid, generator, ops,
                   num_steps=1):
        for _ in range(num_steps):
            positions, generator = step(positions, edges_padded, valid,
                                        generator, ops)
        return positions, generator

    if _debug_knn:
        multi_step = None  # the debug step's output can't feed the loop
    if return_raw:
        return step, multi_step, step_ops, body
    return step, multi_step, step_ops
