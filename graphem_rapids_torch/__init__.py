"""graphem_rapids_torch — the GraphEm layout engine in PyTorch and CUDA.

A port of ``graphem_rapids_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The JAX package is the reference this package is held
against; this package never imports it, nor JAX.

    import graphem_rapids_torch as grt
    emb = grt.GraphEmbedderTorch(adj, n_components=3)   # CUDA by default
    pos = emb.run_layout(50)

Pass ``device='cpu'`` to run on the CPU (the kNN kernel then runs its plain
PyTorch version).
"""

from .convert import state_from_jax
from .models.embedder import GraphEmbedderTorch

__version__ = "0.1.0"

__all__ = ["GraphEmbedderTorch", "state_from_jax"]
