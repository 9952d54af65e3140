"""graphem_rapids_torch — the GraphEm layout engine in PyTorch and CUDA.

A port of ``graphem_rapids_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The JAX package is the reference this package is held
against; this package never imports it, nor JAX.

    import graphem_rapids_torch as grt
    adj = grt.erdos_renyi_graph(n=1000, p=0.01)
    emb = grt.create_graphem(adj, n_components=3, seed=42)  # CUDA
    emb.run_layout(50)
    seeds = grt.graphem_seed_selection(emb, k=10)
    spread = grt.estimated_influence(adj, seeds, p=0.1)

The toolkit of the JAX package comes along: the 13 graph generators (numpy
and scipy), the dataset loaders, the benchmarks (``run_benchmark``, ...)
and the reports; networkx, pandas and plotly are needed only by the
functions that return or draw their objects.

Pass ``device='cpu'`` to run on the CPU (the kNN kernels then run their
plain PyTorch versions); without it every entry point needs a CUDA card.

The sharded tier runs one rank per card over ``torch.distributed``
(``torchrun --nproc-per-node=N``):

    grt.distributed_init()
    emb = grt.create_graphem(adj, backend="sharded", knn_comm="ring_pallas")
"""

import logging
import os

import numpy as np
import torch

from .benchmark import (
    benchmark_correlations,
    run_benchmark,
    run_influence_benchmark,
)
from .convert import state_from_jax
from .datasets import (
    list_available_datasets,
    load_dataset,
    load_dataset_as_adjacency,
    load_dataset_as_networkx,
)
from .generators import (
    compute_vertex_degrees,
    erdos_renyi_graph,
    generate_ba,
    generate_balanced_tree,
    generate_bipartite_graph,
    generate_caveman,
    generate_geometric,
    generate_power_cluster,
    generate_random_regular,
    generate_relaxed_caveman,
    generate_road_network,
    generate_sbm,
    generate_scale_free,
    generate_ws,
)
from .influence import (
    estimated_influence,
    graphem_seed_selection,
    greedy_seed_selection,
    ndlib_estimated_influence,
)
from .models.embedder import GraphEmbedderTorch
from .parallel import (
    ShardedGraphEmbedder,
    default_mesh,
    distributed_init,
    make_mesh,
)
from .utils.backend_selection import (
    BackendConfig,
    check_cuda_availability,
    check_device_count,
    get_default_config,
    get_optimal_backend,
)
from .visualization import (
    display_benchmark_results,
    plot_radial_vs_centrality,
    report_corr,
    report_full_correlation_matrix,
)

__version__ = "0.1.0"

# Migration aliases: graphem-rapids exports its engine as
# GraphEmbedderPyTorch and its large-scale tier as GraphEmbedderCuVS; here
# one engine covers both through its kNN strategies.
GraphEmbedderPyTorch = GraphEmbedderTorch
GraphEmbedderCuVS = GraphEmbedderTorch


def create_graphem(adjacency, n_components=2, backend=None, mesh=None,
                   **kwargs):
    """Create a graph embedder with automatic strategy selection.

    Parameters
    ----------
    adjacency : array-like or scipy.sparse matrix, square.
    n_components : int, default=2 — embedding dimensionality.
    backend : str, optional — force a strategy: 'auto' | 'exact' |
        'chunked' | 'approx' | 'binfold' | 'pallas' | 'sharded' (legacy
        aliases 'pytorch',
        'cuda', 'gpu', 'tpu', 'cpu', and 'cuvs'/'rapids', which select
        'pallas'). GRAPHEM_BACKEND, GRAPHEM_PREFER_GPU (or
        GRAPHEM_PREFER_TPU), GRAPHEM_MEMORY_LIMIT and GRAPHEM_VERBOSE are
        honored.
    mesh : parallel.mesh.Mesh, optional — the ranks of the 'sharded'
        strategy; default ``default_mesh()``: every rank of the initialized
        process group, or one rank without one. Other strategies ignore it.
    **kwargs : forwarded to GraphEmbedderTorch or ShardedGraphEmbedder
        (``device``, ``seed``, ``knn_comm``, ...).

    One difference from the JAX factory, deliberate: 'chunked' is not moved
    to the CPU when no accelerator is found (without a card, and without
    ``device='cpu'``, the engine raises).
    """
    if "index_type" in kwargs:
        # graphem-rapids' cuVS index knob: there is no ANN index to build
        # here, so it is accepted and dropped
        idx = kwargs.pop("index_type")
        logging.getLogger(__name__).info(
            "index_type=%r ignored: the engine has no ANN index", idx
        )
    n_vertices = adjacency.shape[0]
    # undirected i<j edges ~ nnz / 2 on a symmetric matrix
    try:
        nnz = adjacency.nnz
    except AttributeError:
        nnz = int(np.count_nonzero(np.asarray(adjacency)))
    config = get_default_config(
        n_vertices, n_components, n_edges=max(nnz // 2, 1)
    )
    if backend is not None:
        config.force_backend = backend
        config.__post_init__()

    strategy = get_optimal_backend(config)
    if strategy == "sharded":
        return ShardedGraphEmbedder(
            adjacency, n_components=n_components, mesh=mesh, **kwargs
        )
    return GraphEmbedderTorch(
        adjacency, n_components=n_components, knn_strategy=strategy, **kwargs
    )


def get_backend_info():
    """Hardware and strategy availability: torch and CUDA versions, the
    CUDA device count and name, the ranks of the process group (1 without
    one), and the recommended strategy: 'sharded' across several ranks,
    else 'auto' on a card (the engine resolves the kernel itself) and
    'chunked' without one."""
    cuda = check_cuda_availability()
    ranks = check_device_count()
    if ranks > 1:
        recommended = "sharded"
    else:
        recommended = "auto" if cuda else "chunked"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": cuda,
        "cuda_device_count": torch.cuda.device_count() if cuda else 0,
        "cuda_device_name": torch.cuda.get_device_name(0) if cuda else None,
        "distributed_ranks": ranks,
        "recommended_backend": recommended,
    }


__all__ = [
    # factory and engines
    "create_graphem",
    "GraphEmbedderTorch",
    "ShardedGraphEmbedder",
    "GraphEmbedderPyTorch",
    "GraphEmbedderCuVS",
    "make_mesh",
    "default_mesh",
    "distributed_init",
    # graph generators
    "erdos_renyi_graph",
    "generate_sbm",
    "generate_ba",
    "generate_ws",
    "generate_caveman",
    "generate_geometric",
    "generate_scale_free",
    "generate_road_network",
    "generate_balanced_tree",
    "generate_power_cluster",
    "generate_random_regular",
    "generate_bipartite_graph",
    "generate_relaxed_caveman",
    "compute_vertex_degrees",
    # influence maximization
    "graphem_seed_selection",
    "ndlib_estimated_influence",
    "estimated_influence",
    "greedy_seed_selection",
    # visualization
    "report_corr",
    "report_full_correlation_matrix",
    "plot_radial_vs_centrality",
    "display_benchmark_results",
    # datasets
    "load_dataset",
    "load_dataset_as_networkx",
    "load_dataset_as_adjacency",
    "list_available_datasets",
    # utilities
    "get_backend_info",
    "BackendConfig",
    "get_optimal_backend",
    "check_cuda_availability",
    "state_from_jax",
    # benchmarks
    "run_benchmark",
    "benchmark_correlations",
    "run_influence_benchmark",
]


def _show_backend_info():
    """Print the torch version, the CUDA cards (count and kind) and the
    recommended strategy."""
    info = get_backend_info()
    status = [f"torch {info['torch_version']}"]
    if info["cuda_available"]:
        status.append(f"CUDA {info['cuda_version']} ✓ "
                      f"({info['cuda_device_count']}x "
                      f"{info['cuda_device_name']})")
    else:
        status.append("CUDA ✗ (cpu)")
    print(f"GraphEm Rapids torch v{__version__} - {' | '.join(status)}")
    print(f"Recommended strategy: {info['recommended_backend'].upper()}")


def backend_info_main():
    """Console-script entry (``graphem-torch-info``): print the backend
    info and exit 0."""
    _show_backend_info()


# The banner is opt-in, as in the JAX package: GRAPHEM_RAPIDS_QUIET=false
# (or 0) prints it at import; the console entry point prints it on demand.
if os.environ.get("GRAPHEM_RAPIDS_QUIET", "true").lower() in ("false", "0"):
    try:
        _show_backend_info()
    except Exception:  # a cosmetic banner never breaks the import
        pass
