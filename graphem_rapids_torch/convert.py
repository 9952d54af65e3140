"""Carry layout state from the JAX package to the PyTorch port.

The layout engine has no weights: its carried state is the positions, the
iteration count and the graph shape; the neighbor tables are rebuilt from
the same edges, and both packages' builders derive identical tables.

Nothing else needs converting. The factory (``create_graphem``), the
strategy selection and the IC simulator hold no learned state; seed lists
and spreads are plain arrays; and positions cross through the
``positions`` setter and ``GraphEmbedderTorch.load_checkpoint``.
"""

import numpy as np

_FIELDS = ("positions", "iteration", "n", "n_components", "n_edges")


def state_from_jax(npz_or_dict):
    """State dict from a ``GraphEmbedderTPU.save_checkpoint`` file.

    ``npz_or_dict`` is a path, an open file, or a mapping with the
    checkpoint's fields. Returns ``dict(positions, iteration, n,
    n_components, n_edges)`` with positions as (n, d) float32 in user
    vertex order. The JAX PRNG ``key`` is dropped: a torch generator cannot
    take it, so ``GraphEmbedderTorch.load_checkpoint`` reseeds instead.
    """
    if hasattr(npz_or_dict, "keys"):
        data = npz_or_dict
    else:
        with np.load(npz_or_dict) as npz:
            data = {k: npz[k] for k in npz.files}
    missing = [f for f in _FIELDS if f not in data]
    if missing:
        raise ValueError(f"not a GraphEmbedderTPU checkpoint: missing {missing}")
    positions = np.asarray(data["positions"], np.float32)
    n = int(data["n"])
    n_components = int(data["n_components"])
    if positions.shape != (n, n_components):
        raise ValueError(
            f"checkpoint positions have shape {positions.shape}, expected "
            f"({n}, {n_components})"
        )
    return {
        "positions": positions,
        "iteration": int(data["iteration"]),
        "n": n,
        "n_components": n_components,
        "n_edges": int(data["n_edges"]),
    }
