"""Benchmark API: embed generated graphs and score the layout.

Counterpart of ``graphem_rapids_tpu/benchmark.py`` on GraphEmbedderTorch
and the port's influence functions: generators return sparse adjacencies,
and the benchmarks consume them directly. The ground-truth centralities
come from networkx, imported only when they are computed.
"""

import logging
import time

import numpy as np
from scipy import stats

from .influence import (
    estimated_influence,
    graphem_seed_selection,
    greedy_seed_selection,
)
from .models.embedder import GraphEmbedderTorch

logger = logging.getLogger(__name__)

CENTRALITY_MEASURES = (
    "degree", "betweenness", "eigenvector", "pagerank", "closeness",
    "node_load",
)


def _adjacency_to_nx(adjacency):
    """The adjacency as a networkx graph (imports networkx)."""
    import networkx as nx

    return nx.from_scipy_sparse_array(adjacency)


def compute_centralities(nx_graph):
    """The six ground-truth centralities of a networkx graph, with the
    eigenvector -> degree fallback (imports networkx)."""
    import networkx as nx

    n = nx_graph.number_of_nodes()

    def to_array(d):
        out = np.zeros(n)
        for i, val in d.items():
            out[i] = val
        return out

    degree = np.array([d for _, d in nx_graph.degree()], float)
    betweenness = to_array(nx.betweenness_centrality(nx_graph))
    try:
        eigenvector = to_array(nx.eigenvector_centrality_numpy(nx_graph))
    except (nx.NetworkXException, RuntimeError, ValueError) as e:
        logger.warning(
            "Eigenvector centrality failed (%s); using degree centrality", e
        )
        eigenvector = to_array(nx.degree_centrality(nx_graph))
    pagerank = to_array(nx.pagerank(nx_graph))
    closeness = to_array(nx.closeness_centrality(nx_graph))
    node_load = to_array(nx.load_centrality(nx_graph))
    return {
        "degree": degree,
        "betweenness": betweenness,
        "eigenvector": eigenvector,
        "pagerank": pagerank,
        "closeness": closeness,
        "node_load": node_load,
    }


def run_benchmark(graph_generator, graph_params, dim=3, L_min=10.0,
                  k_attr=0.5, k_inter=0.1, n_neighbors=15, sample_size=512,
                  num_iterations=40, backend="auto", compute_centrality=True,
                  **kwargs):
    """Generate a graph, embed it, and collect timings + centralities.

    ``graph_generator(**graph_params)`` returns an adjacency; the embedder
    is GraphEmbedderTorch with ``knn_strategy=backend`` and ``**kwargs``
    (``device``, ``seed``, ``init``, ...). The centralities need networkx;
    ``compute_centrality=False`` runs without it. Returns a dict with graph
    stats, layout_time, radii, positions, and the six centrality arrays.
    """
    logger.info("Running benchmark with %s...", graph_generator.__name__)
    start_time = time.time()

    adjacency = graph_generator(**graph_params)
    n = adjacency.shape[0]
    m = int(adjacency.nnz // 2)
    logger.info("Generated graph with %d vertices and %d edges", n, m)

    centralities = {}
    if compute_centrality:
        logger.info("Calculating centrality measures...")
        centralities = compute_centralities(_adjacency_to_nx(adjacency))

    logger.info("Creating embedder...")
    embedder = GraphEmbedderTorch(
        adjacency,
        n_components=dim,
        L_min=L_min,
        k_attr=k_attr,
        k_inter=k_inter,
        n_neighbors=n_neighbors,
        sample_size=sample_size,
        knn_strategy=backend if backend != "auto" else "auto",
        verbose=False,
        **kwargs,
    )

    logger.info("Running layout for %d iterations...", num_iterations)
    layout_start = time.time()
    embedder.run_layout(num_iterations=num_iterations)
    layout_time = time.time() - layout_start

    positions = embedder.positions
    radii = np.linalg.norm(positions, axis=1)

    result = {
        "n": n,
        "m": m,
        "density": 2 * m / (n * (n - 1)) if n > 1 else 0.0,
        "avg_degree": 2 * m / n if n > 0 else 0.0,
        "layout_time": layout_time,
        "edges_per_second": m * num_iterations / layout_time
        if layout_time > 0 else 0.0,
        "graph_type": graph_generator.__name__,
        "n_components": dim,
        "backend": backend,
        "radii": radii,
        "positions": positions,
        **centralities,
    }
    result["total_time"] = time.time() - start_time
    logger.info("Benchmark completed in %.2f seconds", result["total_time"])
    return result


def benchmark_correlations(graph_generator, graph_params, dim=2, L_min=10.0,
                           k_attr=0.5, k_inter=0.1, n_neighbors=15,
                           sample_size=512, num_iterations=40,
                           backend="auto", **kwargs):
    """run_benchmark + Spearman rho of radius vs each centrality."""
    results = run_benchmark(
        graph_generator, graph_params, dim=dim, L_min=L_min, k_attr=k_attr,
        k_inter=k_inter, n_neighbors=n_neighbors, sample_size=sample_size,
        num_iterations=num_iterations, backend=backend, **kwargs,
    )
    radii = results["radii"]
    correlations = {}
    for measure in CENTRALITY_MEASURES:
        rho, p = stats.spearmanr(radii, results[measure])
        correlations[measure] = {"rho": rho, "p": p}
    results["correlations"] = correlations
    return results


def run_influence_benchmark(graph_generator, graph_params, k=10, p=0.1,
                            iterations=200, dim=3, num_layout_iterations=20,
                            layout_params=None, backend="auto",
                            num_random_baselines=10, num_sims=32, seed=0,
                            device=None):
    """GraphEm vs greedy vs random seed selection under IC spread, on
    ``device`` (None: the CUDA card). The influence functions take the
    adjacency itself, so networkx is not needed."""
    logger.info(
        "Running influence benchmark with %s...", graph_generator.__name__
    )
    start_time = time.time()

    adjacency = graph_generator(**graph_params)
    n = adjacency.shape[0]
    m = int(adjacency.nnz // 2)
    logger.info("Generated graph with %d vertices and %d edges", n, m)

    if layout_params is None:
        layout_params = {
            "L_min": 10.0,
            "k_attr": 0.5,
            "k_inter": 0.1,
            "n_neighbors": 15,
            "sample_size": 512,
        }

    logger.info("Creating embedder...")
    embedder = GraphEmbedderTorch(
        adjacency, n_components=dim, verbose=False, device=device,
        knn_strategy=backend if backend else "auto", **layout_params
    )

    logger.info("Running GraphEm seed selection...")
    graphem_start = time.time()
    graphem_seeds = graphem_seed_selection(
        embedder, k, num_iterations=num_layout_iterations
    )
    graphem_time = time.time() - graphem_start

    logger.info("Running greedy seed selection...")
    greedy_start = time.time()
    greedy_seeds, greedy_iters = greedy_seed_selection(
        adjacency, k, p, iterations, num_sims=num_sims, seed=seed,
        device=device,
    )
    greedy_time = time.time() - greedy_start

    logger.info("Evaluating influence...")
    graphem_influence = estimated_influence(
        adjacency, graphem_seeds, p, iterations, num_sims=num_sims,
        device=device,
    )
    greedy_influence = estimated_influence(
        adjacency, greedy_seeds, p, iterations, num_sims=num_sims,
        device=device,
    )

    rng = np.random.default_rng(seed)
    random_influences = [
        estimated_influence(
            adjacency, rng.choice(n, k, replace=False), p, iterations,
            num_sims=num_sims, device=device,
        )
        for _ in range(num_random_baselines)
    ]
    random_influence = float(np.mean(random_influences))

    results = {
        "graph_type": graph_generator.__name__,
        "n": n,
        "m": m,
        "backend": backend,
        "graphem_seeds": graphem_seeds,
        "greedy_seeds": greedy_seeds,
        "graphem_influence": graphem_influence,
        "greedy_influence": greedy_influence,
        "random_influence": random_influence,
        "graphem_time": graphem_time,
        "greedy_time": greedy_time,
        "greedy_iterations": greedy_iters,
        "graphem_norm_influence": graphem_influence / n,
        "greedy_norm_influence": greedy_influence / n,
        "random_norm_influence": random_influence / n,
    }
    results["graphem_efficiency"] = (
        results["graphem_norm_influence"] / graphem_time
        if graphem_time > 0 else 0
    )
    results["greedy_efficiency"] = (
        results["greedy_norm_influence"] / greedy_time
        if greedy_time > 0 else 0
    )
    results["total_time"] = time.time() - start_time
    logger.info("Influence benchmark completed")
    return results
