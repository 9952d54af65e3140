"""Batched Independent-Cascade simulation in PyTorch.

Counterpart of ``graphem_rapids_tpu/ops/ic_sim.py``. All Monte-Carlo runs
advance together: when a node first activates it gets exactly one chance
to activate each inactive neighbour with probability p, and a run ends when
its frontier is empty. The spread counts every activated node.

Two frontier updates, as in the JAX package:

- gather (``_ic_run_table``, the default): a self-padded in-neighbour table
  (n, cap) int32 and the above-cap hub in-edges sorted by destination
  (``build_cascade_plan``). The whole cascade is one call of
  ``ops/ic_cascade.py``: on a card one launch of the CUDA kernel
  ``csrc/ic_cascade.cu``, which holds the step loop, the frontier test and
  the coins on the card as JAX's jitted ``while_loop`` does, on state
  packed 32 columns to an int32 word, its steps driven by the frontier
  along the plan's push lists (built on the card once per plan, where a
  card runs the cascade); on the CPU its plain version. Coins are Philox
  draws keyed by one 64-bit key from the caller's generator and counted
  by (step, vertex, slot, column), so the card and the CPU give the same
  counts from the same key;
- scatter (``_ic_run``, the fallback for graphs whose table would exceed
  TABLE_BUDGET_SLOTS): every directed edge ORs its fired attempts into
  the receiver's hit words. The whole cascade is one call of
  ``ops/ic_scatter.py``: on a card one launch of ``csrc/ic_scatter.cu``
  over the (2E,) int32 edge list (``directed_edges``) and its push lists
  (``edge_push_lists``, built on the card once per list), with the same
  packed state, the same stop rule and the same Philox coins (the
  directed edge index as the slot); on the CPU its plain version.

A greedy chunk's cascade passes ``runs``, its runs per candidate: column b
draws the coins of run b mod runs, so run r of every candidate (and of
the base group) sees the same coins.

The coins differ from jax.random's, so the two packages agree in
distribution, not run by run.
"""

import numpy as np
import torch

from ..utils import tracing
from .forces import _optimal_table_cap
from .ic_cascade import (
    LONG_ROW,
    PUSH_SORT_CHUNK,
    coin_threshold,
    column_mask_words,
    draw_key,
    frontier_work,
    ic_cascade,
    row_chunks,
    table_push_lists,
)
from .ic_scatter import edge_push_lists, ic_scatter

# Beyond this many table slots the gather formulation's memory stops paying
# for itself; the scatter path takes over (the JAX package's bound).
TABLE_BUDGET_SLOTS = 1 << 27


def _generator(key, device):
    """A torch.Generator on ``device``: ``key`` is one already, or an int
    seed (None means 0, as the JAX package's PRNGKey(0) default)."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


def int32_edges(edges):
    """The (E, 2) int32 form of an undirected edge list, copied only where
    it is not int32 already: the port's vertex ids are int32, so n must be
    below 2^31."""
    return np.asarray(edges).reshape(-1, 2).astype(np.int32, copy=False)


def _dst_list(edges, device):
    """``dst = [e1; e0]``, the (2E,) int32 receivers of the undirected edge
    list's two directions in the JAX package's order, built on ``device``
    (None: the edges' own, the CPU for a numpy array) from one upload of
    the (E, 2) int32 edges. Its half-turn is ``src = [e0; e1]``: directed
    edge i runs from dst[(i + E) mod 2E] to dst[i]. Where the upload
    copies the edges to a device they were not on, their bytes as copied
    are added to the counter ``ic.upload.bytes``."""
    home = edges.device if isinstance(edges, torch.Tensor) \
        else torch.device("cpu")
    e = torch.as_tensor(edges, device=device)
    if e.device != home:
        tracing.count("ic.upload.bytes", e.numel() * e.element_size())
    e = e.to(torch.int32).reshape(-1, 2)
    return torch.cat([e[:, 1], e[:, 0]])


def directed_edges(edges, device):
    """(src, dst) (2E,) int32 tensors of the undirected edge list on
    ``device``: both directions, ``src = [e0; e1]`` and ``dst = [e1; e0]``
    (the JAX package's order), built there from one upload of the edges
    (span ``ic.upload``; counter ``ic.upload.bytes``, ``_dst_list``)."""
    with tracing.span("ic.upload"):
        dst = _dst_list(edges, device)
        return dst.roll(dst.shape[0] // 2), dst


def _ic_run(src, dst, words, p, generator, num_cols, max_iters, runs=None,
            lists=None, stats=None):
    """Scatter-formulation batched IC cascade: one ``ic_scatter`` call.

    src, dst : (2E,) int32 directed edges (``directed_edges``).
    lists : their push lists (``edge_push_lists``), which a card needs.
    words : (n, W) int32 packed seed words of ``num_cols`` columns, one
    seed set per column; column b draws the coins of run b mod ``runs``
    (None: every column its own). One key is drawn from ``generator``.
    Returns (num_cols,) int32 final activated counts, on the words'
    device. A dict ``stats`` receives the final 'active' words and the
    'steps', and on a card the launch's 'dense_steps' and 'outcome'
    (``ic_cascade.launch_result``). The launch is the span ``ic.cascade``.
    """
    with tracing.span("ic.cascade"):
        active, counts, steps = ic_scatter(
            src, dst, words, draw_key(generator), coin_threshold(p),
            int(max_iters), int(num_cols), runs, lists=lists,
            stats=stats if words.is_cuda else None)
    if stats is not None:
        stats.update(active=active, steps=steps)
    return counts


def wants_push_lists(device):
    """Whether the cascades on ``device`` need push lists: only the CUDA
    kernels read them."""
    return torch.device(device).type == "cuda"


def cascade_plan_arrays(edges, n, device=None, stats=None):
    """The gather IC's plan as int32 tensors on ``device`` (None: the
    edges' own, the CPU for a numpy array), or None when the table would
    exceed TABLE_BUDGET_SLOTS: 'table' (n, cap) (row v = in-neighbours of
    v, padded with v: a self slot never creates an activation, because v
    in the frontier implies v active), 'ov_dst'/'ov_src' (O,) sorted by dst
    (the above-cap hub in-edges) and 'ov_ptr' (n + 1,), the row starts of
    that list.

    The edges are uploaded once and every pass over them runs where they
    are: the receivers of the directed lists (``_dst_list``), a stable sort
    by destination (the permutation of numpy's stable argsort), the row
    starts by a search of the sorted keys (no atomics, which pile up on a
    hub's row), each in-edge's source gathered from the receivers' half-
    turn, its rank in its row, and the table filled by one scatter to
    unique places. Only the (n,) degrees come to the host, for
    ``_optimal_table_cap``. The degrees come from sorts of at most
    PUSH_SORT_CHUNK receivers (the push lists' bound), so that a plan past
    the budget stops without ever holding the whole sort; where one chunk
    holds them all its sort is the plan's. Nothing of the build outlives
    it but the four arrays. Spans: ``ic.plan``, with the stages
    ``ic.plan.directed`` (the upload and the receivers), ``ic.plan.sort``
    (the sorts, the row starts and the cap) and ``ic.plan.fill`` (the
    sources, the table and the overflow). The counter ``ic.plan.card``
    counts the plans built on a CUDA device, ``ic.plan.over_budget`` the
    plans that stop past the budget; the upload adds to
    ``ic.upload.bytes`` (``_dst_list``). A dict ``stats`` receives
    'chunks', the length of the dense pass's chunk list
    (``table_push_lists``), counted from the degrees already on the
    host."""
    with tracing.span("ic.plan"):
        with tracing.span("ic.plan.directed"):
            dst2 = _dst_list(edges, device)
            dev, m = dst2.device, dst2.shape[0]
        with tracing.span("ic.plan.sort"):
            probe = torch.arange(n + 1, dtype=torch.int32, device=dev)
            deg_in = torch.zeros(n, dtype=torch.int32, device=dev)
            for lo in range(0, max(m, 1), PUSH_SORT_CHUNK):
                d_s, order = torch.sort(dst2[lo:lo + PUSH_SORT_CHUNK],
                                        stable=True)
                starts = torch.searchsorted(d_s, probe, out_int32=True)
                deg_in += starts[1:] - starts[:-1]
            deg = deg_in.cpu().numpy() if m else np.zeros(0, np.int32)
            cap = max(1, _optimal_table_cap(deg, n)) if m else 1
        if n * cap > TABLE_BUDGET_SLOTS:
            tracing.count("ic.plan.over_budget")
            return None
        if m > PUSH_SORT_CHUNK:
            with tracing.span("ic.plan.sort"):
                del d_s, order, starts
                d_s, order = torch.sort(dst2, stable=True)
                starts = torch.searchsorted(d_s, probe, out_int32=True)
        del probe
        with tracing.span("ic.plan.fill"):
            # sorted place j holds directed edge order[j], whose source
            # sits half a turn along the receivers
            s_s = dst2[order.add_(m // 2).remainder_(max(m, 1))]
            del dst2, order
            rank = torch.arange(m, dtype=torch.int32, device=dev) \
                - starts[d_s]
            del starts
            in_t = rank < cap
            table = torch.arange(n, dtype=torch.int32, device=dev)[
                :, None].expand(n, cap).contiguous()
            table.view(-1)[d_s[in_t] * cap + rank[in_t]] = s_s[in_t]
            del rank
            over = ~in_t
            ov_dst, ov_src = d_s[over], s_s[over]
            ov_ptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
            torch.cumsum((deg_in - cap).clamp_(min=0), 0, dtype=torch.int32,
                         out=ov_ptr[1:])
        if stats is not None:
            long = deg[deg >= cap + LONG_ROW].astype(np.int64) - cap
            stats["chunks"] = int(row_chunks(long).sum())
        if dev.type == "cuda":
            tracing.count("ic.plan.card")
        return {"table": table, "ov_dst": ov_dst, "ov_src": ov_src,
                "ov_ptr": ov_ptr}


def upload_plan(arrays, device):
    """The plan's arrays as int32 tensors on ``device`` (span
    ``ic.upload``); tensors already there are not copied."""
    with tracing.span("ic.upload"):
        return {k: torch.as_tensor(a, dtype=torch.int32, device=device)
                for k, a in arrays.items()}


def build_cascade_plan(edges, n, device):
    """Self-padded in-neighbour table + hub overflow for the gather IC, on
    ``device``: ``cascade_plan_arrays`` built there, or None beyond the
    table budget. Where the cascades need them (``wants_push_lists``), the
    kernel's lists under 'push' as (out_ptr, out_recv, out_slot, chunks),
    the push lists and its dense pass's chunk list of the long overflow
    rows, built once here on the device (``table_push_lists``, with the
    chunks' count from the plan's host degrees: no host read)."""
    counts = {}
    arrays = cascade_plan_arrays(edges, n, device, counts)
    if arrays is None:
        return None
    plan = upload_plan(arrays, device)
    if wants_push_lists(device):
        plan["push"] = table_push_lists(plan["table"], plan["ov_src"],
                                        plan["ov_dst"], plan["ov_ptr"],
                                        counts["chunks"])
    return plan


def seed_words(seed_mask, num_sims):
    """Packed (n, W) int32 seed words of an (n,) bool mask, set in all
    ``num_sims`` columns."""
    full = column_mask_words(num_sims, seed_mask.device)
    return torch.where(seed_mask[:, None], full, 0)


def _ic_run_table(plan, words, p, generator, num_cols, max_iters,
                  runs=None, stats=None):
    """Gather-formulation batched IC cascade: one ``ic_cascade`` call.

    words : (n, W) int32 packed seed words of ``num_cols`` columns, one
    seed set per column (a greedy candidate sweep folds C candidates x s
    runs into one batch); column b draws the coins of run b mod ``runs``
    (None: every column its own). One key is drawn from ``generator``.
    Returns (num_cols,) int32 final activated counts, on the plan's
    device. ``stats`` and the span as in ``_ic_run``.
    """
    with tracing.span("ic.cascade"):
        active, counts, steps = ic_cascade(
            plan["table"], plan["ov_ptr"], plan["ov_src"], words,
            draw_key(generator), coin_threshold(p), int(max_iters),
            int(num_cols), runs, lists=plan.get("push"),
            stats=stats if words.is_cuda else None)
    if stats is not None:
        stats.update(active=active, steps=steps)
    return counts


def _read_outcome(counts, stats):
    """(counts (B,) numpy, steps) of a cascade on the host, with one copy:
    on a card ``stats['outcome']`` holds the kernel's steps, dense steps
    and counts in one view of its control words. The span ``ic.read``
    (which waits for the cascade); the counters ``ic.cascades``,
    ``ic.steps``, ``ic.dense_steps`` (none on the CPU, whose plain
    version has no dense step) and ``ic.dense_chunks``, the (chunk, word)
    items the dense steps handed out (the dense steps times the launch's
    ``stats['chunk_items']``; none for the scatter form)."""
    with tracing.span("ic.read"):
        if "outcome" in stats:
            row = stats["outcome"].cpu().numpy()
            steps, dense, counts = int(row[0]), int(row[1]), row[2:]
        else:
            counts, steps, dense = counts.cpu().numpy(), int(
                stats["steps"]), 0
    tracing.count("ic.cascades")
    tracing.count("ic.steps", steps)
    tracing.count("ic.dense_steps", dense)
    tracing.count("ic.dense_chunks", dense * stats.get("chunk_items", 0))
    return counts, steps


def _count_work(stats, lists, steps, max_iters):
    """While a profiler records, the counters ``ic.sources`` and
    ``ic.pushed`` of a cascade run along push ``lists``
    (``frontier_work``, span ``ic.stats``, one more read): exact only when
    the cascade stopped on an empty frontier before ``max_iters``, so a
    cascade that ran them all counts ``ic.stats_capped`` instead. Without a
    profiler nothing runs."""
    if lists is None or not tracing.profiling():
        return
    if steps >= max_iters:
        tracing.count("ic.stats_capped")
        return
    with tracing.span("ic.stats"):
        sources, pushed = frontier_work(stats["active"],
                                        lists[0]).tolist()
    tracing.count("ic.sources", sources)
    tracing.count("ic.pushed", pushed)


def independent_cascade(edges, n, seeds, p=0.1, num_sims=64, max_iters=200,
                        key=None, plan=None, device=None):
    """Monte-Carlo IC spread for a seed set.

    edges : (E, 2) int array, the undirected edge list (i < j).
    n : number of vertices. seeds : sequence of int, initially active.
    p : per-edge propagation probability. num_sims : Monte-Carlo batch.
    max_iters : cascade-depth cap. key : int seed or torch.Generator.
    plan : a build_cascade_plan result to reuse (with its push lists).
    device : None is CUDA,
    which must exist; pass 'cpu' to run on the CPU.

    Returns (counts (num_sims,) np.ndarray of activated counts, max_iters).
    """
    from ..models.embedder import resolve_device

    dev = resolve_device(device)
    edges = int32_edges(edges)
    seed_np = np.zeros(n, bool)
    seed_np[np.asarray(list(seeds), np.int64)] = True
    seed_mask = torch.as_tensor(seed_np, device=dev)
    gen = _generator(key, dev)
    words = seed_words(seed_mask, int(num_sims))
    if plan is None:
        plan = build_cascade_plan(edges, n, dev)
    stats = {}
    if plan is not None:
        lists = plan.get("push")
        counts = _ic_run_table(plan, words, float(p), gen, int(num_sims),
                               int(max_iters), stats=stats)
    else:
        src, dst = directed_edges(edges, dev)
        lists = edge_push_lists(src, dst, n) if wants_push_lists(dev) \
            else None
        counts = _ic_run(src, dst, words, float(p), gen, int(num_sims),
                         int(max_iters), lists=lists, stats=stats)
    counts, steps = _read_outcome(counts, stats)
    _count_work(stats, lists, steps, int(max_iters))
    return counts, max_iters


def estimated_influence(edges, n, seeds, p=0.1, num_sims=64, max_iters=200,
                        key=None, device=None):
    """Mean IC spread (float) over a Monte-Carlo batch."""
    counts, _ = independent_cascade(
        edges, n, seeds, p=p, num_sims=num_sims, max_iters=max_iters,
        key=key, device=device,
    )
    return float(np.mean(counts))
