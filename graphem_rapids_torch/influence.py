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

from .models.embedder import resolve_device
from .ops.ic_cascade import column_mask_words, pack_columns_np
from .ops.ic_sim import (
    _generator,
    _ic_run,
    _ic_run_table,
    build_cascade_plan,
    independent_cascade,
)

# Most candidates of one scatter-path sweep chunk (the JAX package's bound).
GREEDY_CAND_CHUNK = 1024
# Bound on the (C * num_sims, 2E) coin block of one scatter-path chunk.
_SCATTER_CHUNK_SLOTS = 1 << 26


def _as_edges_and_n(G):
    """(edges (E, 2), n) from a networkx graph, scipy adjacency or pair."""
    if hasattr(G, "number_of_nodes") and hasattr(G, "edges"):
        n = G.number_of_nodes()
        edges = np.asarray(list(G.edges()), np.int64).reshape(-1, 2)
        return edges, n
    if sp.issparse(G):
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
    """Mean IC spread over ``num_sims`` Monte-Carlo runs, run as one batch."""
    edges, n = _as_edges_and_n(G)
    counts, _ = independent_cascade(
        edges, n, seeds, p=p, num_sims=num_sims, max_iters=iterations_count,
        key=key, device=device,
    )
    return float(np.mean(counts))


def _batched_marginal(src, dst, base_mask, p, generator, cand_ids, num_sims,
                      max_iters):
    """Spread of base_mask + each candidate, on the scatter simulator.

    The C candidates x num_sims runs are the rows of one (C * num_sims, n)
    batch; a candidate already in the seed set gets -inf.
    """
    n = base_mask.shape[0]
    C = cand_ids.shape[0]
    seed = base_mask.expand(C, n).clone()
    seed[torch.arange(C, device=seed.device), cand_ids] = True
    seed = seed.repeat_interleave(num_sims, dim=0)  # (C*s, n)
    counts = _ic_run(src, dst, seed, p, generator, n, C * num_sims,
                     max_iters)
    gains = counts.reshape(C, num_sims).to(torch.float32).mean(dim=1)
    return torch.where(base_mask[cand_ids], -torch.inf, gains)


def _marginal_chunk_table(plan, base_mask, p, generator, cand_ids, num_sims,
                          max_iters):
    """Spread of base_mask + each candidate, on the gather simulator.

    The C candidates x num_sims runs are the columns of one (n, C * s)
    cascade (column c * s + r is run r of candidate c), whose packed seed
    words are built directly: every column of a base vertex, and
    candidate c's s columns in its row. One ``ic_cascade`` call, one key
    drawn from ``generator``. A candidate already in the seed set gets
    -inf.
    """
    C = cand_ids.shape[0]
    B = C * num_sims
    dev = base_mask.device
    full = column_mask_words(B, dev)
    words = torch.where(base_mask[:, None], full, 0)
    cand_bits = torch.as_tensor(pack_columns_np(
        np.repeat(np.eye(C, dtype=bool), num_sims, axis=1)), device=dev)
    # the candidates' column sets are disjoint, so the sum over a row that
    # appears twice (the padded tail of a chunk) is their OR
    cand_words = torch.zeros_like(words).index_put_(
        (cand_ids,), cand_bits, accumulate=True)
    counts = _ic_run_table(plan, words | cand_words, p, generator, B,
                           max_iters)
    gains = counts.reshape(C, num_sims).to(torch.float32).mean(dim=1)
    return torch.where(base_mask[cand_ids], -torch.inf, gains)


def greedy_seed_selection(G, k, p=0.1, iterations_count=200, num_sims=32,
                          seed=0, device=None):
    """Greedy marginal-gain seed selection.

    Candidates x Monte-Carlo runs fold into one batched cascade per chunk
    on the gather simulator (one ``ic_cascade`` launch per chunk on a
    card); rounds after the first re-evaluate only the
    C highest stale candidates (batched CELF, as the JAX package does).
    Graphs whose cascade table exceeds the budget take the full sweep of
    ``_greedy_scatter``.

    Returns (seeds list, total simulated cascades).
    """
    dev = resolve_device(device)
    edges, n = _as_edges_and_n(G)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
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

    def eval_chunk(cands_np, base_mask):
        return _marginal_chunk_table(
            plan, base_mask, float(p), gen,
            torch.as_tensor(cands_np, device=dev), int(num_sims),
            int(iterations_count),
        ).cpu().numpy()

    seeds = []
    total_evals = 0
    base_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    gains = np.full(n_pad, -np.inf, np.float32)
    for c0 in range(0, n_pad, C):
        gains[c0:c0 + C] = eval_chunk(cand_all[c0:c0 + C], base_mask)
    gains = gains[:n]
    total_evals += n * num_sims
    fresh = np.ones(n, bool)

    while len(seeds) < k:
        order = np.argsort(-gains)
        top = int(order[0])
        if fresh[top]:
            seeds.append(top)
            base_mask[top] = True
            gains[top] = -np.inf
            fresh[:] = False
            continue
        # batched CELF: re-evaluate the C highest stale candidates
        stale_top = order[~fresh[order]][:C]
        batch = np.zeros(C, np.int64)
        batch[:len(stale_top)] = stale_top
        vals = eval_chunk(batch, base_mask)
        gains[stale_top] = vals[:len(stale_top)]
        fresh[stale_top] = True
        total_evals += len(stale_top) * num_sims
    return seeds, total_evals


def _greedy_scatter(edges, n, k, p, iterations_count, num_sims, generator):
    """Full-sweep greedy on the scatter simulator: every round evaluates
    every candidate. The fallback for graphs beyond the gather budget."""
    dev = generator.device
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    src = torch.as_tensor(np.concatenate([edges[:, 0], edges[:, 1]]),
                          device=dev)
    dst = torch.as_tensor(np.concatenate([edges[:, 1], edges[:, 0]]),
                          device=dev)
    seeds = []
    total_evals = 0
    base_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    per_cand = max(num_sims * max(len(src), n), 1)
    C = max(1, min(GREEDY_CAND_CHUNK, n, _SCATTER_CHUNK_SLOTS // per_cand))
    cand_all = torch.arange(n, device=dev)
    for _ in range(k):
        gains = torch.cat([
            _batched_marginal(src, dst, base_mask, float(p), generator,
                              cand_all[c0:c0 + C], int(num_sims),
                              int(iterations_count))
            for c0 in range(0, n, C)
        ])
        best = int(torch.argmax(gains))
        seeds.append(best)
        base_mask[best] = True
        total_evals += (n - len(seeds) + 1) * num_sims
    return seeds, total_evals
