"""The port's float accumulator (ops/segment.py) and the determinism it
gives the layout.

The accumulator adds each row's terms in ascending contribution order, as
``index_add_`` does on the CPU. On the CPU its plain path is held bit-equal
to ``index_add_`` and to a numpy float32 loop in ascending order, in both
forms (dynamic ids, and static ids sorted once). The card's two dynamic
forms are modeled with numpy on their plain versions: the cluster kernel's
one sorted order (and its radix passes over the cluster's blocks) and the
tiled form's row walk each give index_add_'s bits, and the dispatch takes
the cluster form up to its capacity and the tiled form past it. The step
ops that moved from ``index_add_`` onto it are held bit-equal to their
``index_add_`` forms, the edge-sharded spring sum on a two-rank gloo mesh
among them. The engine gives the same layout for the same seed, and a run
resumed from a checkpoint equals the uninterrupted run. Tests marked
``cuda`` need a card and skip without one; they hold the kernels bit-equal
to the CPU's index_add_ (and the cluster kernel to its plain version,
under graph replay too) and the engine's seeded and resumed runs bit-equal
on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_determinism.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch import GraphEmbedderTorch
from graphem_rapids_torch.ops import forces as tf
from graphem_rapids_torch.ops import laplacian as lap
from graphem_rapids_torch.ops import segment as seg

REPO = Path(__file__).resolve().parent.parent
K_ATTR, L_MIN, K_INTER = 0.5, 10.0, 0.1
PARAMS = dict(n_components=3, L_min=10.0, k_attr=0.5, k_inter=0.1,
              n_neighbors=8, sample_size=128, verbose=False)


def _terms(case, rows=40, M=600, d=3, seed=0):
    """(ids, values, out) for an accumulator case: many ties and gaps,
    rows with no terms, an empty input, a nonzero start."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        M = 0
    ids = rng.integers(0, rows // 2, M) * 2  # odd rows get no term
    ids[: M // 3] = rng.integers(0, 3, M // 3) * 2  # long runs of ties
    shape = (M, d) if d else (M,)
    values = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -3, 4, shape)).astype(np.float32)
    oshape = (rows, d) if d else (rows,)
    out = np.zeros(oshape, np.float32)
    if case == "base":
        out = rng.standard_normal(oshape).astype(np.float32)
    return ids.astype(np.int64), values, out


def _loop(out, ids, values):
    """out[ids[j]] += values[j] in ascending j, in float32."""
    out = out.copy()
    for j in range(len(ids)):
        out[ids[j]] = out[ids[j]] + values[j]
    return out


def _index_add(out, ids, values):
    return torch.from_numpy(out.copy()).index_add_(
        0, torch.from_numpy(ids), torch.from_numpy(values)).numpy()


@pytest.mark.fast
@pytest.mark.parametrize("case", ["ties_and_gaps", "empty", "base"])
@pytest.mark.parametrize("d", [0, 3], ids=["vector", "rows"])
@pytest.mark.parametrize("form", ["dynamic", "static"])
def test_plain_path_is_index_add_and_ascending_loop(form, d, case):
    ids, values, out = _terms(case, d=d)
    want = _loop(out, ids, values)
    np.testing.assert_array_equal(_index_add(out, ids, values), want)
    got = torch.from_numpy(out.copy())
    if form == "dynamic":
        res = seg.segment_sum(got, torch.from_numpy(ids),
                              torch.from_numpy(values))
    else:
        perm = np.argsort(ids, kind="stable")
        res = seg.segment_sum_sorted(got, torch.from_numpy(ids[perm]),
                                     torch.from_numpy(values),
                                     torch.from_numpy(perm))
    assert res is got  # in place, as index_add_
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.fast
def test_static_form_without_perm_takes_values_in_key_order():
    ids, values, out = _terms("base")
    order = np.argsort(ids, kind="stable")
    got = seg.segment_sum_sorted(torch.from_numpy(out.copy()),
                                 torch.from_numpy(ids[order]),
                                 torch.from_numpy(values[order]))
    np.testing.assert_array_equal(got.numpy(), _loop(out, ids, values))


def _static_terms(case, d=3, seed=0):
    """(keys ascending int64, values in key order, out) of a static plan:
    'one_row' 25,600 terms into one row; 'short' runs of 1-2 terms;
    'mixed' runs of 1-2 among runs of 60-5,000 and one of 22,841 (the 1M
    heavy-tail graph's widest hub), in a shuffled order of rows; 'empty'
    none."""
    rng = np.random.default_rng(seed)
    counts = {
        "one_row": np.array([25_600]),
        "short": rng.integers(1, 3, 5000),
        "mixed": np.concatenate([rng.integers(1, 3, 3000),
                                 rng.integers(60, 5000, 40), [22_841]]),
        "empty": np.zeros(0, np.int64),
    }[case]
    rng.shuffle(counts)
    rows = max(len(counts), 1)
    keys = np.repeat(np.arange(len(counts)), counts).astype(np.int64)
    shape = (len(keys), d) if d else (len(keys),)
    values = rng.standard_normal(shape).astype(np.float32)
    oshape = (rows, d) if d else (rows,)
    out = rng.standard_normal(oshape).astype(np.float32)
    return keys, values, out


@pytest.mark.fast
@pytest.mark.parametrize("form", ["numpy", "int32", "int64"])
@pytest.mark.parametrize("case", ["one_row", "short", "mixed", "empty",
                                  "perm"])
def test_static_walk_finds_the_runs(case, form):
    """The static kernel's table of runs against np.unique, from a numpy
    array or an int32 or int64 tensor of keys: each run starts where
    np.unique first sees its key, ends after its count, and is long when it
    has LONG_RUN terms or more ('mixed' holds runs on both sides of it).
    'perm': the sorted keys of unsorted ids, as the scatter plan keeps them
    beside a perm."""
    if case == "perm":
        ids = np.random.default_rng(3).integers(0, 700, 9000)
        keys = np.sort(ids, kind="stable")
    else:
        keys = _static_terms(case)[0]
    arg = keys if form == "numpy" else torch.from_numpy(keys).to(
        getattr(torch, form))
    starts, ends, is_long = seg.static_runs_reference(arg)
    _, first, count = np.unique(keys, return_index=True, return_counts=True)
    np.testing.assert_array_equal(starts, first)
    np.testing.assert_array_equal(ends, first + count)
    np.testing.assert_array_equal(is_long, count >= seg.LONG_RUN)
    if case == "mixed":
        assert is_long.any() and (~is_long).any()


@pytest.mark.fast
@pytest.mark.parametrize("case", ["one_row", "mixed", "perm"])
def test_static_runs_in_order_give_index_add_bits(case):
    """Each run of the model added in order onto its row, through the perm
    where there is one, gives the CPU's index_add_ bits, as does
    segment_sum_sorted's plain path on the same arguments."""
    if case == "perm":
        ids, values, out = _terms("base", rows=700, M=9000)
        ids[:4000] = 5  # one long run among short ones
        perm = np.argsort(ids, kind="stable")
        keys = ids[perm]
    else:
        keys, values, out = _static_terms(case)
        ids, perm = keys, np.arange(len(keys))
    want = _index_add(out, ids, values)
    got = out.copy()
    starts, ends, _ = seg.static_runs_reference(keys)
    for a, b in zip(starts, ends):
        got[keys[a]] = _loop(got[keys[a]][None], np.zeros(b - a, np.int64),
                             values[perm[a:b]])[0]
    np.testing.assert_array_equal(got, want)
    plain = seg.segment_sum_sorted(
        torch.from_numpy(out.copy()), torch.from_numpy(keys),
        torch.from_numpy(values), torch.from_numpy(perm))
    np.testing.assert_array_equal(plain.numpy(), want)


def _tiled_walk(ids, rows):
    """The order in which the card's kernel adds the terms: (row, term)
    pairs as its owners walk them, from the tile sort's plain version.
    Checks the tiles' layout on the way."""
    keys, perm, T, L, mask = seg.sort_tiles_reference(torch.from_numpy(ids),
                                                      rows)
    M = len(ids)
    assert (T, L) == seg.tile_shape(M) and T * L >= M
    assert T == 1 or T * L - M < T
    keys = keys.numpy().reshape(T, L)
    perm = perm.numpy().reshape(T, L)
    term = np.arange(T)[:, None] * L + perm
    real = keys != seg.PAD_KEY
    assert real.sum() == M and (term[~real] >= M).all()
    for t in range(T):
        assert (np.diff(keys[t].astype(np.int64)) >= 0).all()
        # stable within the tile: equal keys in term order
        same = keys[t, 1:] == keys[t, :-1]
        assert (np.diff(perm[t])[same] > 0).all()
    if T > 1:
        bits = mask.numpy().view(np.uint64)
        assert bits.shape == (rows, seg.mask_words(T))
        for t in range(T):
            has = np.zeros(rows, bool)
            has[keys[t][real[t]]] = True
            np.testing.assert_array_equal(
                (bits[:, t // 64] >> np.uint64(t % 64)) & 1, has)
        # no bit past the last tile
        last = np.uint64((T - 1) % 64)
        assert not (bits[:, -1] >> last >> np.uint64(1)).any()
    else:
        assert mask is None
    # an owner walks its row's runs tile by tile: tile-major, then a
    # stable sort by row
    flat_keys, flat_terms = keys[real], term[real]
    order = np.argsort(flat_keys, kind="stable")
    return flat_keys[order], flat_terms[order]


@pytest.mark.fast
@pytest.mark.parametrize("M", [1, 700, 1025, 5000, 9000, 66000, 140000])
def test_tiled_walk_gives_index_add_bits(M):
    """The tiles, their masks and the row walk of the card's form: adding
    the terms in the walk's order gives index_add_'s bits, with masks of
    one, two and three words (past 64 and 128 tiles)."""
    rows = 300
    rng = np.random.default_rng(M)
    ids = rng.integers(0, rows, M)
    ids[: M // 2] = rng.integers(0, 4, M // 2)  # rows across many tiles
    values = (rng.standard_normal((M, 3)) * 1e3).astype(np.float32)
    out = rng.standard_normal((rows, 3)).astype(np.float32)
    row, term = _tiled_walk(ids, rows)
    walked = out.copy()
    np.add.at(walked, row, values[term])  # unbuffered: in the walk's order
    np.testing.assert_array_equal(walked, _index_add(out, ids, values))


def _cluster_radix_model(ids, rows, groups=seg.CLUSTER_GROUPS):
    """The cluster kernel's passes in numpy. Cluster g takes the rows of
    its range; in pass 0 its block b reads terms [b * m0, b * m0 + m0) and
    keeps those, in later passes it holds places [b * c, b * c + c) of the
    cluster's order; each pass places a key at its digit's first place in
    the cluster's order (keys of smaller digits, then this digit's in
    earlier blocks), plus the digit's keys before it in its block. Returns
    (rows, terms) in the clusters' orders, one after another."""
    B = seg.CLUSTER_BLOCKS
    M = len(ids)
    m0 = -(-M // B)
    groups, span = seg.cluster_rows(rows, groups)
    passes, width = seg.radix_digits(span)
    found = []
    for g in range(groups):
        mine = (ids >= g * span) & (ids < g * span + span)
        key = np.stack([ids.astype(np.int64), np.arange(M)], axis=1)
        blocks = [key[b * m0:(b + 1) * m0][mine[b * m0:(b + 1) * m0]]
                  for b in range(B)]
        for p in range(passes):
            digit = [((k[:, 0] - g * span) >> (width * p)) & ((1 << width) - 1)
                     for k in blocks]
            count = np.stack([np.bincount(x, minlength=1 << width)
                              for x in digit])
            total = count.sum(0)
            base = (np.cumsum(total) - total)[None, :] \
                + np.cumsum(count, axis=0) - count
            nxt = np.empty((int(total.sum()), 2), np.int64)
            for b in range(B):
                seen = np.zeros(1 << width, np.int64)
                for k, x in zip(blocks[b], digit[b]):
                    nxt[base[b, x] + seen[x]] = k
                    seen[x] += 1
            c = max(1, -(-len(nxt) // B))
            blocks = [nxt[b * c:(b + 1) * c] for b in range(B)]
        found.extend(blocks)
    key = np.concatenate(found)
    return key[:, 0], key[:, 1]


@pytest.mark.fast
@pytest.mark.parametrize("M", [1, 1025, 30720, 98304, seg.CLUSTER_MAX_TERMS,
                               seg.CLUSTER_MAX_TERMS + 1])
def test_cluster_walk_gives_index_add_bits(M):
    """The cluster kernel's order: one stable sort of the whole id list, so
    each row's terms form one contiguous run in ascending term order, with
    rows that recur across the cluster's blocks; adding the terms in
    that order gives index_add_'s bits. Up to a few thousand terms the
    kernel's radix passes, modeled block by block, give the same order."""
    rows = 300
    rng = np.random.default_rng(M)
    ids = rng.integers(0, rows, M)
    # runs of 16 equal ids in the first half (as intersection_forces'
    # repeat_interleave), and rows 0-3 in every third term throughout
    ids[: M // 2] = np.repeat(rng.integers(0, rows, -(-M // 32)), 16)[:M // 2]
    ids[1::3] = rng.integers(0, 4, len(ids[1::3]))
    values = (rng.standard_normal((M, 3)) * 1e3).astype(np.float32)
    out = rng.standard_normal((rows, 3)).astype(np.float32)
    row, term = (x.numpy() for x in seg.cluster_walk_reference(
        torch.from_numpy(ids)))
    np.testing.assert_array_equal(np.sort(term), np.arange(M))
    np.testing.assert_array_equal(ids[term], row)
    assert (np.diff(row) >= 0).all()
    same = row[1:] == row[:-1]
    assert (np.diff(term)[same] > 0).all()
    # each row's run is contiguous: one start per distinct row
    assert 1 + (~same).sum() == np.unique(ids).size
    B = seg.CLUSTER_BLOCKS
    if M > 16 * B:
        c = -(-M // B)
        blocks = [set(ids[b * c:(b + 1) * c]) for b in range(B)]
        assert set.intersection(*blocks)  # a row in every block
    walked = out.copy()
    np.add.at(walked, row, values[term])  # unbuffered: in the walk's order
    want = _index_add(out, ids, values)
    np.testing.assert_array_equal(walked, want)
    got = seg.segment_sum_cluster_reference(
        torch.from_numpy(out.copy()), torch.from_numpy(ids),
        torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(), want)
    if M <= 30720:
        model = _cluster_radix_model(ids, rows)
        np.testing.assert_array_equal(model[0], row)
        np.testing.assert_array_equal(model[1], term)


@pytest.mark.fast
@pytest.mark.parametrize("span,digits", [
    (1, (1, 1)), (2, (1, 1)), (1024, (1, 10)), (1025, (2, 6)),
    (12_500, (2, 7)), (125_000, (2, 9)), (2**24 + 1, (3, 9)),
    (2**31, (4, 8))])
def test_cluster_radix_passes_cover_the_rows(span, digits):
    """A cluster sorts its range of rows by as few digits of at most 10
    bits as the range needs, one pass at least (it gathers the cluster's
    terms)."""
    assert seg.radix_digits(span) == digits


@pytest.mark.fast
@pytest.mark.parametrize("rows,groups", [(1, 8), (2, 8), (300, 8), (300, 1),
                                         (257, 3), (70_000, 7),
                                         (2**24 + 1, 8)])
def test_cluster_passes_model_the_stable_sort(rows, groups):
    """The clusters' ranges of rows and their passes, modeled block by
    block, give the stable sort of the ids, up to the last row."""
    assert seg.cluster_rows(rows, groups)[0] == min(rows, groups)
    rng = np.random.default_rng(rows)
    ids = rng.integers(0, rows, 3000)
    ids[:40] = rows - 1
    ids[100:400] = 0
    row, term = _cluster_radix_model(ids, rows, groups)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(row, ids[order])
    np.testing.assert_array_equal(term, order)


@pytest.mark.fast
@pytest.mark.parametrize("M", [0, 1, seg.CLUSTER_MAX_TERMS,
                               seg.CLUSTER_MAX_TERMS + 1, 3 * 10**5])
def test_dynamic_form_by_the_number_of_terms(monkeypatch, M):
    """On a card, segment_sum takes one cluster launch up to the capacity
    the card reports and the tile sort and the tiled sum past it; no terms,
    no launch. The kernels are stood in for by recorders here."""
    calls = []
    monkeypatch.setattr(seg, "cluster_max_terms",
                        lambda device: seg.CLUSTER_MAX_TERMS)
    monkeypatch.setattr(seg, "segment_sum_cluster",
                        lambda out, ids, values: calls.append("cluster")
                        or out)
    monkeypatch.setattr(seg, "sort_tiles",
                        lambda ids, rows: calls.append("sort_tiles")
                        or seg.sort_tiles_reference(ids, rows))
    monkeypatch.setattr(seg, "segment_sum_cuda",
                        lambda out, *a, **k: calls.append("tiled_sum") or out)
    out = torch.zeros(50, 3)
    ids = torch.from_numpy(np.random.default_rng(M).integers(0, 50, M))
    assert seg._card_dynamic(out, ids, torch.zeros(M, 3)) is out
    if M == 0:
        assert calls == []
    elif M <= seg.CLUSTER_MAX_TERMS:
        assert calls == ["cluster"]
    else:
        assert calls == ["sort_tiles", "tiled_sum"]


@pytest.mark.fast
def test_tile_shape():
    assert seg.tile_shape(0) == (1, 0)
    assert seg.tile_shape(seg.TILE) == (1, seg.TILE)
    assert seg.tile_shape(seg.TILE + 1) == (2, seg.TILE // 2 + 1)
    assert seg.tile_shape(30720) == (30, 1024)  # the main path's 4 * S * k
    assert seg.tile_shape(98304) == (96, 1024)  # 'approx': n_neighbors=48
    assert seg.tile_shape(65537) == (65, 1009)
    assert [seg.mask_words(T) for T in (2, 64, 65, 128, 129)] == [
        1, 1, 2, 2, 3]


@pytest.mark.fast
def test_kernel_wrapper_checks_its_inputs():
    """The CUDA wrapper refuses CPU tensors, and the dispatching forms never
    reach it for them."""
    out = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        seg.segment_sum_cuda(out, torch.zeros(2, dtype=torch.int64),
                             torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        seg.segment_sum_cluster(out, torch.zeros(2, dtype=torch.int64),
                                torch.zeros(2, 3))


# ---------------------------------------------------------------------- #
# the step ops against their index_add_ forms
# ---------------------------------------------------------------------- #

def _graph(n=200, m=900, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    e = np.concatenate([e, np.column_stack([np.zeros(150, int),
                                            rng.integers(1, n, 150)]),
                        np.column_stack([np.ones(90, int),
                                         rng.integers(2, n, 90)])])
    e = e[e[:, 0] != e[:, 1]]
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 3
    return e, n, pos


def _plan_t(plan):
    return {k: (v if k == "block" else torch.from_numpy(np.asarray(v)).long())
            for k, v in plan.items()}


def _old_intersection(positions, edges, knn_indices, sampled, k_inter):
    """intersection_forces as it summed with index_add_."""
    n = positions.shape[0]
    k = knn_indices.shape[1]
    ci = torch.repeat_interleave(sampled.long(), k)
    cj = knn_indices.reshape(-1).long()
    ei, ej = edges[ci], edges[cj]
    share = ((ei[:, 0] == ej[:, 0]) | (ei[:, 0] == ej[:, 1])
             | (ei[:, 1] == ej[:, 0]) | (ei[:, 1] == ej[:, 1]))
    hit = tf.segments_intersect_2d(positions[ei[:, 0]], positions[ei[:, 1]],
                                   positions[ej[:, 0]], positions[ej[:, 1]])
    w = ((ci < cj) & ~share & hit).to(positions.dtype)[:, None]
    vals = tf._repulsion_terms(positions, ei, ej, w, float(k_inter))
    ids = torch.cat([ei[:, 0], ei[:, 1], ej[:, 0], ej[:, 1]])
    return torch.zeros_like(positions).index_add_(0, ids, vals)


@pytest.mark.fast
def test_intersection_forces_bit_equal_to_index_add_form():
    e, n, pos = _graph(seed=1)
    rng = np.random.default_rng(1)
    pos_t, e_t = torch.from_numpy(pos), torch.from_numpy(e)
    sampled = torch.from_numpy(rng.choice(len(e), 64, replace=False))
    mid = (pos_t[e_t[:, 0]] + pos_t[e_t[:, 1]]) / 2
    d2 = torch.cdist(mid[sampled], mid)
    knn = torch.topk(d2, 9, largest=False).indices[:, 1:]
    got = tf.intersection_forces(pos_t, e_t, knn, sampled, K_INTER)
    want = _old_intersection(pos_t, e_t, knn, sampled, K_INTER)
    assert (want != 0).any()
    assert torch.equal(got, want)


@pytest.mark.fast
@pytest.mark.parametrize("form", ["block_plan", "coo"])
def test_table_overflow_bit_equal_to_index_add_form(form):
    e, n, pos = _graph(seed=2)
    nb = tf.build_neighbor_table(e, n, cap=6)
    pos_t = torch.from_numpy(pos)
    pn = pos_t[torch.from_numpy(nb["table"]).long()]
    base = tf._spring(pn - pos_t[:, None, :], K_ATTR, L_MIN).sum(dim=1)
    if form == "block_plan":
        plan = _plan_t(nb["overflow_plan"])
        got = tf.spring_forces_binned(pos_t, [pn], tf.table_buckets(nb),
                                      K_ATTR, L_MIN, overflow_plan=plan)
        fo = tf._overflow_spring(pos_t, plan["pairs"], K_ATTR, L_MIN)
        blk = fo.reshape(-1, plan["block"], 3).sum(dim=1)
        hub = torch.zeros(len(plan["hub_ids"]), 3).index_add_(
            0, plan["block_hub"], blk)
        want = base.index_add(0, plan["hub_ids"], hub)
    else:
        ov = torch.from_numpy(nb["overflow"]).long()
        got = tf.spring_forces_binned(pos_t, [pn], tf.table_buckets(nb),
                                      K_ATTR, L_MIN, overflow_edges=ov)
        fo = tf._overflow_spring(pos_t, ov, K_ATTR, L_MIN)
        want = base.index_add(0, ov[:, 0], fo)
    assert torch.equal(got, want)


@pytest.mark.fast
@pytest.mark.parametrize("use_plan", [False, True])
def test_spring_scatter_form_bit_equal_to_index_add_form(use_plan):
    e, n, pos = _graph(seed=3)
    pos_t, e_t = torch.from_numpy(pos), torch.from_numpy(e)
    plan = tf.build_scatter_plan(e, n, device="cpu") if use_plan else None
    got = tf.spring_forces(pos_t, e_t, K_ATTR, L_MIN, scatter_plan=plan)
    f = tf._spring(pos_t[e_t[:, 1]] - pos_t[e_t[:, 0]], K_ATTR, L_MIN)
    vals = torch.cat([f, -f])
    if use_plan:
        want = torch.zeros(n, 3).index_add_(0, plan["sorted_ids"],
                                            vals[plan["perm"]])
    else:
        want = torch.zeros(n, 3).index_add_(
            0, torch.cat([e_t[:, 0], e_t[:, 1]]), vals)
    assert torch.equal(got, want)


@pytest.mark.fast
@pytest.mark.parametrize("builder,native", [
    ("flat", True), ("flat", False), ("binned", True), ("binned", False),
    ("chebyshev", None)])
def test_coo_overflow_rows_ascend(builder, native):
    """The COO overflow tails that the step and the SpMV sum with the static
    form (``segment_sum_sorted``, no sort) come with their rows in
    ascending order from every builder, with and without the C helpers."""
    if builder == "flat":
        e, n, _ = _graph(seed=4)
        ov = tf.build_neighbor_table(e, n, cap=3, native=native)["overflow"]
    elif builder == "binned":
        # two hubs over a ring: several buckets, the hubs past their cap
        ring = np.column_stack([np.arange(3000),
                                (np.arange(3000) + 1) % 3000])
        hubs = np.column_stack([np.repeat([0, 1], 900),
                                np.tile(np.arange(2, 902), 2)])
        e = np.unique(np.sort(np.concatenate([ring, hubs]), axis=1), axis=0)
        nb = tf.build_neighbor_table_binned(e, 3000, overhead_rows=64,
                                            native=native)
        ov = nb["overflow"]
    else:
        ov = lap._adjacency_matvec_plan(regular_graph(300, cycles=3),
                                        cap=5)["overflow"].numpy()
    ov = np.asarray(ov)
    assert ov.shape[0] > 0
    assert (np.diff(ov[:, 0].astype(np.int64)) >= 0).all()


def _star_path(hub=200, path=40):
    """A hub of ``hub`` leaves and a path: the SpMV's hub overflows."""
    e = [(0, j) for j in range(1, hub + 1)]
    e += [(hub + i, hub + i + 1) for i in range(1, path)]
    e = np.array(e)
    n = hub + path + 1
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    a = (a + a.T).tocsr()
    a.data[:] = 1
    return a


@pytest.mark.fast
@pytest.mark.parametrize("form", ["block_plan", "coo"])
def test_chebyshev_overflow_bit_equal_to_index_add_form(form):
    """_overflow_correct with the hub block plan (a star) and with a COO
    tail (one pair past the cap on most rows, which no block size beats)
    against its index_add_ form."""
    if form == "block_plan":
        A, cap = _star_path(), None
    else:
        A, cap = regular_graph(300, cycles=3), 5
    plan = lap._adjacency_matvec_plan(A, cap=cap)
    if form == "block_plan":
        assert plan["ov_plan"] is not None
    else:
        assert plan["ov_plan"] is None and plan["overflow"].shape[0] > 0
    X = np.random.default_rng(0).standard_normal((A.shape[0], 8)).astype(
        np.float32)
    Y_ext = torch.from_numpy(np.concatenate([X, np.zeros((1, 8), X.dtype)]))
    AY = Y_ext[plan["table"]].sum(dim=1)
    want = AY.clone()
    got = lap._overflow_correct(AY, Y_ext, plan)
    ov = plan["ov_plan"]
    if ov is not None:
        blk = Y_ext[ov["nbr"]].reshape(-1, ov["block"], 8).sum(dim=1)
        hub = torch.zeros(len(ov["hub_ids"]), 8).index_add_(
            0, ov["block_hub"], blk)
        want.index_add_(0, ov["hub_ids"], hub)
    else:
        o = plan["overflow"]
        want.index_add_(0, o[:, 0], Y_ext[o[:, 1]])
    assert torch.equal(got, want)


def _edge_sharded(mesh, world, rank):
    """(the edge-sharded step's standardized spring, the same by
    index_add_ over this rank's edge shard and an all_reduce)."""
    from graphem_rapids_torch.parallel.sharded_step import (
        build_sharded_step,
        pad_edges,
    )

    e, n, pos = _graph(n=150, m=700, seed=4)
    edges_p, valid = pad_edges(e.astype(np.int32), world)
    edges_p = torch.from_numpy(edges_p).long()
    valid = torch.from_numpy(valid)
    pos_t = torch.from_numpy(pos)
    _, _, ops, raw = build_sharded_step(
        mesh, n, len(e), n_components=3, k_attr=K_ATTR, L_min=L_MIN,
        k_inter=K_INTER, n_neighbors=5, sample_size=32, _debug_spring=True,
        return_raw=True)
    got = raw(pos_t, edges_p, valid, None, ops)
    E_loc = len(edges_p) // world
    loc = edges_p[rank * E_loc:(rank + 1) * E_loc]
    f = tf._spring(pos_t[loc[:, 1]] - pos_t[loc[:, 0]], K_ATTR, L_MIN) \
        * valid[rank * E_loc:(rank + 1) * E_loc, None]
    spring = mesh.all_reduce(torch.zeros_like(pos_t).index_add_(
        0, torch.cat([loc[:, 0], loc[:, 1]]), torch.cat([f, -f])))
    s0 = spring - spring.mean(dim=0, keepdim=True)
    want = s0 / (s0.std(dim=0, keepdim=True, unbiased=True) + 1e-6)
    return got.numpy(), want.numpy()


def worker(rank, world, store, out):
    """One gloo rank of the edge-sharded sum: writes out/rank<r>.npz."""
    torch.set_num_threads(1)
    from graphem_rapids_torch.parallel import distributed_init, make_mesh

    distributed_init(backend="gloo", init_method=f"file://{store}",
                     world_size=world, rank=rank)
    got, want = _edge_sharded(make_mesh(world), world, rank)
    np.savez(Path(out) / f"rank{rank}.npz", got=got, want=want)
    torch.distributed.destroy_process_group()


@pytest.mark.fast
def test_edge_sharded_sum_on_two_gloo_ranks(tmp_path):
    """The edge-sharded spring sum on a two-rank gloo mesh: bit-equal to
    its index_add_ form on each rank, and the ranks agree."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), "2",
         str(tmp_path / "store"), str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in res:
        np.testing.assert_array_equal(r["got"], r["want"])
    np.testing.assert_array_equal(res[0]["got"], res[1]["got"])


@pytest.mark.fast
def test_edge_sharded_sum_on_one_rank():
    from graphem_rapids_torch.parallel import make_mesh

    got, want = _edge_sharded(make_mesh(device="cpu"), 1, 0)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- #
# the engine: one seed, one layout
# ---------------------------------------------------------------------- #

def regular_graph(n=2000, cycles=3, seed=1):
    rng = np.random.default_rng(seed)
    e = []
    for _ in range(cycles):
        p = rng.permutation(n)
        e.append(np.column_stack([p, np.roll(p, -1)]))
    e = np.concatenate(e)
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def hub_graph(n=3000, seed=2):
    """Random edges and two hubs: binned tables with an overflow plan."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 1500)] + [(1, j) for j in range(2, 800)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (6000, 2)) if a != b]
    e = np.unique(np.array(e, np.int64), axis=0)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1
    return a


GRAPHS = {"flat": (regular_graph, "random", "flat"),
          "hub": (hub_graph, "chebyshev", "binned+overflow plan")}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _engine(graph, device, seed=7):
    make, init, _ = GRAPHS[graph]
    return GraphEmbedderTorch(make(), device=device, init=init, seed=seed,
                              knn_strategy="binfold" if device == "cuda"
                              else "exact", **PARAMS)


@pytest.mark.fast
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_same_seed_same_layout(device, graph):
    """Two engines of one seed: equal starts and equal positions after 20
    iterations (replayed on a card)."""
    a, b = _engine(graph, device), _engine(graph, device)
    assert a.table_kind == GRAPHS[graph][2]
    np.testing.assert_array_equal(a.positions, b.positions)
    pa, pb = a.run_layout(20), b.run_layout(20)
    assert np.isfinite(pa).all()
    np.testing.assert_array_equal(pa, pb)


@pytest.mark.fast
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_resume_from_checkpoint_equals_straight_run(device, graph,
                                                    tmp_path):
    """10 iterations, a checkpoint, 10 more: a new engine resumed from the
    checkpoint ends bit-equal to the uninterrupted run."""
    straight = _engine(graph, device)
    straight.run_layout(10)
    straight.save_checkpoint(tmp_path / "ckpt.npz")
    want = straight.run_layout(10)
    resumed = _engine(graph, device, seed=99)
    resumed.load_checkpoint(tmp_path / "ckpt.npz")
    np.testing.assert_array_equal(resumed.run_layout(10), want)


# ---------------------------------------------------------------------- #
# the kernel on a card
# ---------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 1000, 1025, 30720, 65536, 70000, 98304,
                               140000])
@pytest.mark.parametrize("case", ["ties_and_gaps", "base"])
def test_card_dynamic_form_bit_equal_to_cpu(cuda_device, M, case):
    ids, values, out = _terms(case, rows=50000, M=M)
    want = _index_add(out, ids, values)
    for _ in range(2):
        got = seg.segment_sum(torch.from_numpy(out).to(cuda_device),
                              torch.from_numpy(ids).to(cuda_device),
                              torch.from_numpy(values).to(cuda_device))
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_card_cluster_capacity(cuda_device):
    """The capacity comes from the card's shared memory: every engine's
    step (98,304 terms at most) fits; an H100 gives CLUSTER_MAX_TERMS."""
    most = seg.cluster_max_terms(cuda_device)
    assert most >= 98304
    if "H100" in torch.cuda.get_device_name(cuda_device):
        assert most == seg.CLUSTER_MAX_TERMS


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 1000, 1025, 30720, 65536, 70000, 98304,
                               131072, 140000])
@pytest.mark.parametrize("case", ["ties_and_gaps", "base"])
def test_card_cluster_form_bit_equal_to_cpu(cuda_device, M, case):
    """One cluster launch per call, bit-equal to the CPU's index_add_ and to
    its plain version; past the capacity the cluster kernel refuses the
    call and segment_sum takes the tiled form."""
    ids, values, out = _terms(case, rows=50000, M=M)
    want = _index_add(out, ids, values)
    plain = seg.segment_sum_cluster_reference(
        torch.from_numpy(out.copy()), torch.from_numpy(ids),
        torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(plain, want)
    args = [torch.from_numpy(x).to(cuda_device) for x in (out, ids, values)]
    counts = (seg.segment_sum_cluster.launches, seg.sort_tiles.launches)
    if M > seg.cluster_max_terms(cuda_device):
        with pytest.raises(ValueError, match="terms"):
            seg.segment_sum_cluster(*args)
        seg.segment_sum(*args)
        assert (seg.segment_sum_cluster.launches,
                seg.sort_tiles.launches) == (counts[0], counts[1] + 1)
        return
    for _ in range(2):
        got = seg.segment_sum_cluster(args[0].clone(), *args[1:])
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    got = seg.segment_sum(*args)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert (seg.segment_sum_cluster.launches,
            seg.sort_tiles.launches) == (counts[0] + 3, counts[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 256, 257, 2**24 + 1])
@pytest.mark.parametrize("d", [0, 1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_card_cluster_form_rows_widths_and_ids(cuda_device, rows, d, dtype):
    """The cluster kernel with no radix pass (one row) up to four (2^24 + 1
    rows), vector and row values, int32 and int64 ids; a row in every
    block, a run across blocks."""
    rng = np.random.default_rng(rows + d)
    M = 30720
    ids = rng.integers(0, rows, M)
    ids[::7] = rows - 1
    ids[8000:20000] = 0
    shape = (M, d) if d else (M,)
    values = rng.standard_normal(shape).astype(np.float32)
    out = rng.standard_normal((rows, d) if d else (rows,)).astype(np.float32)
    want = _index_add(out, ids, values)
    got = seg.segment_sum_cluster(
        torch.from_numpy(out).to(cuda_device),
        torch.from_numpy(ids).to(dtype).to(cuda_device),
        torch.from_numpy(values).to(cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [30720, 98304])
def test_card_cluster_form_under_graph_replay(cuda_device, M):
    """A capture of one cluster call replays bit-equal, one launch a
    replay."""
    ids, values, out = _terms("base", rows=100000, M=M)
    want = _index_add(out, ids, values)
    ids_c = torch.from_numpy(ids).to(cuda_device)
    vals_c = torch.from_numpy(values).to(cuda_device)
    base = torch.from_numpy(out).to(cuda_device)
    buf = base.clone()
    seg.segment_sum_cluster(buf, ids_c, vals_c)  # eager first: builds it
    before = seg.segment_sum_cluster.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.copy_(base)
        seg.segment_sum_cluster(buf, ids_c, vals_c)
    assert seg.segment_sum_cluster.launches == before + 1
    for _ in range(3):
        graph.replay()
        np.testing.assert_array_equal(buf.cpu().numpy(), want)


def _card_static(case, d, with_perm, dtype, device):
    """A static call on the card: (out, keys, values, perm) there, and the
    CPU's index_add_ of its terms."""
    if case == "base":
        ids, values, out = _terms("base", rows=5000, M=20000, d=d)
    else:
        keys, values, out = _static_terms(case, d=d)
        # the same terms in another order, which the perm undoes
        shuffle = np.random.default_rng(1).permutation(len(keys))
        ids, values = keys[shuffle], values[shuffle]
    perm = np.argsort(ids, kind="stable")
    want = _index_add(out, ids, values)
    keys = torch.from_numpy(ids[perm]).to(dtype).to(device)
    if with_perm:
        args = (values, torch.from_numpy(perm).to(device))
    else:
        args = (values[perm], None)
    return (torch.from_numpy(out).to(device), keys,
            torch.from_numpy(args[0]).to(device), args[1]), want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["base", "one_row", "mixed"])
@pytest.mark.parametrize("d", [0, 1, 3, 8])
@pytest.mark.parametrize("with_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_card_static_form_bit_equal_to_cpu(cuda_device, case, d, with_perm,
                                           dtype):
    """One launch a call, bit-equal to the CPU's index_add_, twice: the
    base case's short runs, a run of 25,600 terms into one row, and runs
    of 1-2 terms mixed with runs of 60-5,000 and one of 22,841, with and
    without a perm, int32 and int64 keys."""
    (out, keys, values, perm), want = _card_static(case, d, with_perm,
                                                   dtype, cuda_device)
    for _ in range(2):
        before = seg.segment_sum.launches
        got = seg.segment_sum_sorted(out.clone(), keys, values, perm)
        assert seg.segment_sum.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["perm", "d11", "unaligned"])
def test_card_static_form_long_runs_a_lane_adds(cuda_device, why):
    """Long runs that the kernel leaves to the lane at their start give the
    same bits: a call with a perm, one of 11 columns, and values that are
    not 16-byte aligned (a view one float into its storage)."""
    d = 11 if why == "d11" else 3
    (out, keys, values, perm), want = _card_static(
        "mixed", d, why == "perm", torch.int64, cuda_device)
    if why == "unaligned":
        flat = torch.empty(values.numel() + 1, device=cuda_device)
        flat[1:] = values.reshape(-1)
        values = flat[1:].view(values.shape)
        assert values.data_ptr() % 16 != 0 and values.is_contiguous()
    got = seg.segment_sum_sorted(out, keys, values, perm)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_perm", [False, True], ids=["no_perm", "perm"])
def test_card_static_form_under_graph_replay(cuda_device, with_perm):
    """A captured static call replays bit-equal three times, one launch in
    the capture."""
    (base, keys, values, perm), want = _card_static(
        "mixed", 3, with_perm, torch.int32, cuda_device)
    buf = base.clone()
    seg.segment_sum_sorted(buf, keys, values, perm)  # eager first: builds
    before = seg.segment_sum.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.copy_(base)
        seg.segment_sum_sorted(buf, keys, values, perm)
    assert seg.segment_sum.launches == before + 1
    for _ in range(3):
        graph.replay()
        np.testing.assert_array_equal(buf.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 1024, 1025, 30720, 65536, 98304, 140000])
def test_card_tile_sort_equals_plain_version(cuda_device, M):
    ids = torch.from_numpy(np.random.default_rng(M).integers(
        0, 3000, M)).to(cuda_device)
    got = seg.sort_tiles(ids, 3000)
    want = seg.sort_tiles_reference(ids, 3000)
    assert got[2:4] == want[2:4]
    for a, b in zip(got[:2] + got[4:], want[:2] + want[4:]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_card_dynamic_form_under_graph_replay(cuda_device):
    ids, values, out = _terms("base", rows=50000, M=30720)
    want = _index_add(out, ids, values)
    ids_c = torch.from_numpy(ids).to(cuda_device)
    vals_c = torch.from_numpy(values).to(cuda_device)
    base = torch.from_numpy(out).to(cuda_device)
    buf = base.clone()
    seg.segment_sum(buf, ids_c, vals_c)  # eager first: builds the kernel
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.copy_(base)
        seg.segment_sum(buf, ids_c, vals_c)
    for _ in range(3):
        graph.replay()
        np.testing.assert_array_equal(buf.cpu().numpy(), want)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
