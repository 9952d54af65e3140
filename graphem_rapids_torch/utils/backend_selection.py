"""Execution-strategy ("backend") selection.

Counterpart of ``graphem_rapids_tpu/utils/backend_selection.py``, with the
same decision tree, config, legacy aliases and environment variables. The
engine is one; this layer picks its kNN strategy and device tier:

- 'exact'   : one (S, E) distance matrix + top-k (small graphs)
- 'chunked' : blockwise scan with a running top-k (large graphs, CPU hosts)
- 'approx'  : one-shot distances + exact top-k, the chunked scan beyond
              the one-shot budget (ops/knn.py knn_approx)
- 'binfold' : the bin-fold kernel
- 'pallas'  : the exact tiled kNN kernel (the name is the API's)
- 'sharded' : the multi-card tier (parallel/, one rank per card)

The accelerator is a CUDA card: ``check_cuda_availability`` takes the place
of the JAX package's TPU probe, and the ranks of the initialized
``torch.distributed`` process group that of its global device count: the
sharded tier runs one rank per card, so the cards of the host that no rank
drives cannot be sharded over. For the same inputs, the same answer to "is
there an accelerator" and the same device count, ``get_optimal_backend``
returns what the JAX function returns.

Environment variables: GRAPHEM_BACKEND, GRAPHEM_PREFER_GPU (alias
GRAPHEM_PREFER_TPU), GRAPHEM_MEMORY_LIMIT, GRAPHEM_VERBOSE.
"""

import logging
import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

VALID_STRATEGIES = (
    "auto", "exact", "chunked", "approx", "binfold", "pallas", "sharded"
)
LEGACY_ALIASES = {
    "pytorch": "auto",
    "cuda": "auto",
    "gpu": "auto",
    "tpu": "auto",
    "cpu": "chunked",
    "cuvs": "pallas",
    "rapids": "pallas",
}

# Vertex-count tiers, and their edge-count equivalents at average degree 8
# (E = 4n): the kNN ref set and the spring gather scale with E.
LARGE_GRAPH_VERTICES = 100_000
MEDIUM_GRAPH_VERTICES = 10_000
LARGE_GRAPH_EDGES = 4 * LARGE_GRAPH_VERTICES
MEDIUM_GRAPH_EDGES = 4 * MEDIUM_GRAPH_VERTICES


@dataclass
class BackendConfig:
    """Configuration for strategy selection. ``prefer_tpu`` keeps the JAX
    package's field name: it means "prefer the accelerator"."""

    n_vertices: int
    n_components: int = 2
    n_edges: int | None = None
    force_backend: str | None = None
    prefer_tpu: bool = True
    memory_limit: float | None = None  # GB
    verbose: bool = False
    # None = count the ranks of the process group at decision time
    mesh_devices: int | None = field(default=None)

    def __post_init__(self):
        if self.n_vertices <= 0:
            raise ValueError(
                f"n_vertices must be positive, got {self.n_vertices}"
            )
        if self.n_components <= 0:
            raise ValueError(
                f"n_components must be positive, got {self.n_components}"
            )
        if self.force_backend is not None:
            resolved = LEGACY_ALIASES.get(
                self.force_backend, self.force_backend
            )
            if resolved not in VALID_STRATEGIES:
                raise ValueError(
                    f"force_backend must be one of {VALID_STRATEGIES} (or a "
                    f"legacy alias {tuple(LEGACY_ALIASES)}), got "
                    f"{self.force_backend!r}"
                )
            self.force_backend = resolved


def check_cuda_availability():
    """Whether a CUDA card is attached."""
    return torch.cuda.is_available()


def check_device_count():
    """Ranks of the initialized process group, 1 without one: the devices
    the sharded tier can shard over."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def get_data_complexity_score(n_vertices, n_components):
    """Sigmoid complexity score in [0, 1] (informational, for logging)."""
    vertex_score = 1.0 / (1.0 + math.exp(-(n_vertices - 1e6) / 2**18))
    dim_score = 1.0 / (1.0 + math.exp(-(n_components - 5)))
    return 0.8 * vertex_score + 0.2 * dim_score


def estimate_memory_usage(n_vertices, n_components, strategy="exact",
                          sample_size=1024, n_edges=None):
    """Rough working-set estimate in GB; the real edge count when known,
    else the average-degree-8 guess."""
    E = n_edges if n_edges is not None else n_vertices * 4
    pos = n_vertices * n_components * 4
    edges = E * 2 * 4 * 2  # int32 pairs, both scatter directions
    if strategy == "exact":
        # one (S, E) f32 distance block plus the (E, d) f32 ref midpoints
        block = sample_size * max(E, n_vertices) * 4 \
            + max(E, n_vertices) * max(n_components, 1) * 4
    else:
        block = sample_size * 8192 * 4
    return (5 * pos + edges + block) / 1024**3


def get_optimal_backend(config: BackendConfig):
    """Decision tree mapping graph scale and hardware to a strategy."""
    score = get_data_complexity_score(config.n_vertices, config.n_components)
    if config.verbose:
        logger.info("Data complexity score: %.3f", score)

    if config.force_backend and config.force_backend != "auto":
        if config.verbose:
            logger.info("Forced strategy: %s", config.force_backend)
        return config.force_backend

    n = config.n_vertices
    # tier on vertices and edges; unknown E takes the average-degree-8 guess
    E = config.n_edges if config.n_edges is not None else 4 * n
    has_gpu = check_cuda_availability() and config.prefer_tpu
    n_devices = (
        config.mesh_devices
        if config.mesh_devices is not None
        else check_device_count()
    )

    # The multi-device tier only on real accelerators, or when the caller
    # names a device count.
    large = n > LARGE_GRAPH_VERTICES or E > LARGE_GRAPH_EDGES
    if large and n_devices > 1 and (
        has_gpu or config.mesh_devices is not None
    ):
        return "sharded"
    # One accelerator: 'auto', so that the engine's _resolved_strategy, which
    # tiers on the edge count, picks the kernel. Hosts take the exact scan.
    if large:
        return "auto" if has_gpu else "chunked"
    if n > MEDIUM_GRAPH_VERTICES or E > MEDIUM_GRAPH_EDGES:
        if config.memory_limit is not None:
            est = estimate_memory_usage(
                n, config.n_components, "exact",
                n_edges=config.n_edges,
            )
            if est > config.memory_limit:
                return "chunked"
        return "auto" if has_gpu else "chunked"
    return "exact"


def log_backend_selection(strategy, config):
    """Log the selected strategy."""
    logger.info(
        "Selected strategy %s for n=%d, d=%d (cuda=%s, devices=%d)",
        strategy, config.n_vertices, config.n_components,
        check_cuda_availability(), check_device_count(),
    )


def get_default_config(n_vertices, n_components=2, n_edges=None):
    """A BackendConfig that honors the environment variables."""
    prefer = os.environ.get(
        "GRAPHEM_PREFER_GPU", os.environ.get("GRAPHEM_PREFER_TPU", "true")
    ).lower() in ("1", "true", "yes")
    mem = os.environ.get("GRAPHEM_MEMORY_LIMIT")
    return BackendConfig(
        n_vertices=n_vertices,
        n_components=n_components,
        n_edges=n_edges,
        force_backend=os.environ.get("GRAPHEM_BACKEND"),
        prefer_tpu=prefer,
        memory_limit=float(mem) if mem else None,
        verbose=os.environ.get("GRAPHEM_VERBOSE", "false").lower()
        in ("1", "true", "yes"),
    )
