"""Step and host-preparation ops of the PyTorch port.

Counterpart of ``graphem_rapids_tpu/ops``, with the same public names.
"""

from .forces import build_scatter_plan, intersection_forces, spring_forces
from .ic_sim import independent_cascade
from .intersect import segments_intersect_2d
from .knn import knn, knn_approx, knn_chunked, knn_exact
from .laplacian import spectral_init
from .sampling import sample_indices

__all__ = [
    "spring_forces",
    "intersection_forces",
    "build_scatter_plan",
    "segments_intersect_2d",
    "knn",
    "knn_exact",
    "knn_chunked",
    "knn_approx",
    "spectral_init",
    "independent_cascade",
    "sample_indices",
]
