"""Influence maximization: seed selection and Independent-Cascade scoring.

Counterpart of ``graphem_rapids_tpu/influence.py``. Seeds are picked by
embedding radius (``graphem_seed_selection``) or by greedy marginal gain
(``greedy_seed_selection``), and scored with the batched IC simulator of
``ops/ic_sim.py``. NDlib is used for ``ndlib_estimated_influence`` when it
is installed, imported inside that function; without it the simulator runs
one trajectory instead.

Graphs are accepted as a networkx graph (recognized by its
``number_of_nodes`` and ``edges`` methods, so networkx is never imported
here), a scipy sparse adjacency, or an ``(edges, n)`` pair. Every entry
point runs on the CUDA card unless ``device='cpu'`` is given.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .models.embedder import csr_upper_edges, resolve_device
from .ops.ic_cascade import column_mask_words, pack_columns_np
from .ops.ic_scatter import edge_push_lists
from .ops.ic_sim import (
    _generator,
    _ic_run,
    _ic_run_table,
    build_cascade_plan,
    directed_edges,
    independent_cascade,
    int32_edges,
    wants_push_lists,
)
from .utils import tracing

# Most candidates of one scatter-path sweep chunk (the JAX package's bound).
GREEDY_CAND_CHUNK = 1024
# Bound on the (n, W) packed words of one scatter-path chunk's cascade
# (each of the scatter kernel's five (n, W) state arrays: 512 MB).
_SCATTER_STATE_WORDS = 1 << 27


def _as_edges_and_n(G):
    """(edges (E, 2), n) from a networkx graph, scipy adjacency or pair.

    A CSR adjacency's upper triangle is taken by the threaded C scan
    (``csr_upper_edges``, int32), which gives ``nonzero()``'s pairs in its
    order; another sparse format keeps ``nonzero()``, whose order is its
    storage's."""
    if hasattr(G, "number_of_nodes") and hasattr(G, "edges"):
        n = G.number_of_nodes()
        edges = np.asarray(list(G.edges()), np.int64).reshape(-1, 2)
        return edges, n
    if sp.issparse(G):
        if G.format == "csr":
            return csr_upper_edges(G), G.shape[0]
        rows, cols = G.nonzero()
        mask = rows < cols
        return np.column_stack([rows[mask], cols[mask]]), G.shape[0]
    edges, n = G
    return np.asarray(edges), n


def graphem_seed_selection(embedder, k, num_iterations=20):
    """Run the layout, then pick the k nodes with the largest radial
    distance from the origin."""
    embedder.run_layout(num_iterations=num_iterations)
    positions = np.asarray(embedder.positions)
    radial_distances = np.linalg.norm(positions, axis=1)
    seeds = np.argsort(-radial_distances)[:k]
    return seeds.tolist()


def ndlib_estimated_influence(G, seeds, p=0.1, iterations_count=200,
                              key=None, device=None):
    """IC influence with NDlib's semantics: (influenced_count, iterations).

    Uses NDlib (and networkx) when installed, drawing from their global
    random state. Otherwise one trajectory of the simulator, seeded by
    ``key`` (int or torch.Generator; default 0), on ``device``.
    """
    try:
        import ndlib.models.ModelConfig as mc
        import ndlib.models.epidemics as ep
        import networkx as nx
    except ImportError:
        edges, n = _as_edges_and_n(G)
        counts, iters = independent_cascade(
            edges, n, seeds, p=p, num_sims=1, max_iters=iterations_count,
            key=key, device=device,
        )
        return int(counts[0]), iters

    if not isinstance(G, nx.Graph):
        edges, n = _as_edges_and_n(G)
        H = nx.Graph()
        H.add_nodes_from(range(n))
        H.add_edges_from(edges.tolist())
        G = H
    model = ep.IndependentCascadesModel(G)
    config = mc.Configuration()
    for e in G.edges():
        config.add_edge_configuration("threshold", e, p)
    model.set_initial_status(config)
    for seed in seeds:
        config.add_node_configuration("status", seed, 1)
    iterations = model.iteration_bunch(iterations_count)
    final_status = iterations[-1]["status"]
    influenced = sum(1 for s in final_status.values() if s == 2)
    return influenced, len(iterations)


def estimated_influence(G, seeds, p=0.1, iterations_count=200, num_sims=64,
                        key=None, device=None):
    """Mean IC spread over ``num_sims`` Monte-Carlo runs, run as one batch.

    Spans: ``ic.estimate``, with the graph's extraction (``ic.extract``)
    and ``independent_cascade``'s stages under it."""
    with tracing.span("ic.estimate"):
        with tracing.span("ic.extract"):
            edges, n = _as_edges_and_n(G)
        counts, _ = independent_cascade(
            edges, n, seeds, p=p, num_sims=num_sims,
            max_iters=iterations_count, key=key, device=device,
        )
        return float(np.mean(counts))


def _chunk_words(base_mask, cand_ids, num_sims, base_runs=0):
    """Packed (n, W) seed words of one greedy chunk, and its column count
    B = C * num_sims + base_runs: column c * s + r is run r of candidate
    c (every base vertex and candidate c), the last ``base_runs`` columns
    hold the base alone."""
    C = cand_ids.shape[0]
    B = C * num_sims + base_runs
    dev = base_mask.device
    words = torch.where(base_mask[:, None], column_mask_words(B, dev), 0)
    cand = np.zeros((C, B), bool)
    cand[:, :C * num_sims] = np.repeat(np.eye(C, dtype=bool), num_sims,
                                       axis=1)
    cand_bits = torch.as_tensor(pack_columns_np(cand), device=dev)
    # the candidates' column sets are disjoint, so the sum over a row that
    # appears twice (the padded tail of a chunk) is their OR
    cand_words = torch.zeros_like(words).index_put_(
        (cand_ids,), cand_bits, accumulate=True)
    return words | cand_words, B


def _chunk_gains(counts, base_mask, cand_ids, num_sims):
    """Mean spread of each candidate's runs; where the cascade had base
    runs after them, less their mean (sigma(S + v) - sigma(S)). A
    candidate already in the seed set gets -inf."""
    C = cand_ids.shape[0]
    counts = counts.to(torch.float32)
    gains = counts[:C * num_sims].reshape(C, num_sims).mean(dim=1)
    if counts.shape[0] > C * num_sims:
        gains = gains - counts[C * num_sims:].mean()
    return torch.where(base_mask[cand_ids], -torch.inf, gains)


def _batched_marginal(src, dst, lists, base_mask, p, generator, cand_ids,
                      num_sims, max_iters):
    """Spread of base_mask + each candidate, on the scatter simulator
    (``lists``: the edges' push lists).

    The C candidates x num_sims runs are the columns of one (n, C * s)
    cascade (``_chunk_words``), run r of every candidate drawing the same
    coins: one ``ic_scatter`` call, one key drawn from ``generator``. A
    candidate already in the seed set gets -inf.
    """
    words, B = _chunk_words(base_mask, cand_ids, num_sims)
    counts = _ic_run(src, dst, words, p, generator, B, max_iters, num_sims,
                     lists)
    return _chunk_gains(counts, base_mask, cand_ids, num_sims)


def _marginal_chunk_table(plan, base_mask, p, generator, cand_ids, num_sims,
                          max_iters, base_runs):
    """Marginal gains of a chunk of candidates, on the gather simulator.

    The C candidates x num_sims runs are the first columns of one cascade
    (``_chunk_words``: column c * s + r is run r of candidate c); with
    ``base_runs`` = num_sims the base alone follows in as many columns,
    which estimate sigma(S) in the same launch, and each gain is sigma(S +
    v) - sigma(S) (with no base runs, sigma(S + v): right for an empty
    base, whose sigma is 0). Run r of every candidate and of the base
    draws the same coins (common random numbers), so the noise of sigma(S)
    cancels in each gain. One ``ic_cascade`` call, one key drawn from
    ``generator``. A candidate already in the seed set gets -inf.
    """
    words, B = _chunk_words(base_mask, cand_ids, num_sims, base_runs)
    counts = _ic_run_table(plan, words, p, generator, B, max_iters, num_sims)
    return _chunk_gains(counts, base_mask, cand_ids, num_sims)


def greedy_seed_selection(G, k, p=0.1, iterations_count=200, num_sims=32,
                          seed=0, device=None):
    """Greedy marginal-gain seed selection.

    Candidates x Monte-Carlo runs fold into one batched cascade per chunk
    on the gather simulator (one ``ic_cascade`` launch per chunk on a
    card). The first round estimates every candidate's spread; later
    rounds are CELF: the cached marginal gains sigma(S + v) - sigma(S) are
    upper bounds of the current ones (submodularity), so the C highest
    stale candidates are re-evaluated, chunk after chunk, until the top
    candidate is fresh. Each re-evaluation estimates sigma(S) from
    ``num_sims`` base-only runs in the same cascade, run r of the base and
    of every candidate drawing the same coins. (The JAX package's CELF
    caches sigma(S + v), which are lower bounds.) Ties go to the lowest
    vertex id, as the full sweep's argmax. Graphs whose cascade table
    exceeds the budget take the full sweep of ``_greedy_scatter``.

    Returns (seeds list, total simulated runs: num_sims for every
    candidate evaluated, and for every base group of a re-evaluation; the
    padded tail of the first round's last chunk is not counted).
    """
    dev = resolve_device(device)
    edges, n = _as_edges_and_n(G)
    edges = int32_edges(edges)
    gen = _generator(seed, dev)
    plan = build_cascade_plan(edges, n, dev)
    if plan is None:
        return _greedy_scatter(edges, n, k, p, iterations_count, num_sims,
                               gen)

    cap = plan["table"].shape[1]
    # the JAX package's chunk rule (its (n, cap, C*s) gather working set),
    # so that both sweep the same candidate chunks
    C = int(max(1, min(64, n, (1 << 31) // max(n * cap * num_sims, 1))))
    n_pad = -(-n // C) * C
    cand_all = np.zeros(n_pad, np.int64)
    cand_all[:n] = np.arange(n)

    def eval_chunk(cands_np, base_runs):
        return _marginal_chunk_table(
            plan, base_mask, float(p), gen,
            torch.as_tensor(cands_np, device=dev), int(num_sims),
            int(iterations_count), base_runs,
        ).cpu().numpy()

    seeds = []
    total_evals = 0
    base_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    gains = np.full(n_pad, -np.inf, np.float32)
    for c0 in range(0, n_pad, C):  # sigma(empty set) = 0: no base runs
        gains[c0:c0 + C] = eval_chunk(cand_all[c0:c0 + C], 0)
    gains = gains[:n]
    total_evals += n * num_sims
    fresh = np.ones(n, bool)

    while len(seeds) < k:
        order = np.argsort(-gains, kind="stable")
        top = int(order[0])
        if fresh[top]:
            seeds.append(top)
            base_mask[top] = True
            gains[top] = -np.inf
            fresh[:] = False
            continue
        # CELF: re-evaluate the C highest stale candidates
        stale_top = order[~fresh[order]][:C]
        batch = np.zeros(C, np.int64)
        batch[:len(stale_top)] = stale_top
        vals = eval_chunk(batch, int(num_sims))
        gains[stale_top] = vals[:len(stale_top)]
        fresh[stale_top] = True
        total_evals += (len(stale_top) + 1) * num_sims
    return seeds, total_evals


def _scatter_chunk(n, num_sims):
    """Candidates of one scatter-path chunk: GREEDY_CAND_CHUNK (the JAX
    package's), at most n, and fewer where the (n, W) words of C *
    num_sims columns would pass _SCATTER_STATE_WORDS."""
    cols = 32 * (_SCATTER_STATE_WORDS // max(n, 1))
    return max(1, min(GREEDY_CAND_CHUNK, n, cols // max(num_sims, 1)))


def _greedy_scatter(edges, n, k, p, iterations_count, num_sims, generator):
    """Full-sweep greedy on the scatter simulator: every round evaluates
    every candidate, C at a time (``_scatter_chunk``), one ``ic_scatter``
    call each, on one build of the edges' push lists. The fallback for
    graphs beyond the gather budget."""
    dev = generator.device
    src, dst = directed_edges(edges, dev)
    lists = edge_push_lists(src, dst, n) if wants_push_lists(dev) else None
    seeds = []
    total_evals = 0
    base_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    C = _scatter_chunk(n, num_sims)
    cand_all = torch.arange(n, device=dev)
    for _ in range(k):
        gains = torch.cat([
            _batched_marginal(src, dst, lists, base_mask, float(p),
                              generator, cand_all[c0:c0 + C], int(num_sims),
                              int(iterations_count))
            for c0 in range(0, n, C)
        ])
        best = int(torch.argmax(gains))
        seeds.append(best)
        base_mask[best] = True
        total_evals += (n - len(seeds) + 1) * num_sims
    return seeds, total_evals
