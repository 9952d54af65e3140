"""ShardedGraphEmbedder: the multi-card tier of the engine.

Counterpart of ``graphem_rapids_tpu/parallel/sharded_embedder.py``. The same
public surface as GraphEmbedderTorch (run_layout, update_positions,
positions, checkpoints); the layout step is the sharded step of
parallel/sharded_step.py on the ranks of a mesh (parallel/mesh.py).

Every rank builds the same engine from the same graph: the same tables,
the same seed (drawn on rank 0 and broadcast when none is given), rank 0's
initial positions, and a generator seeded alike, so every rank draws the
same sample each iteration, as the JAX tier's replicated key does, and the
positions stay bit-equal across ranks. The Chebyshev init ('chebyshev',
and 'auto' from 500,000 vertices) row-shards its SpMV over the mesh's
ranks. The step broadcasts rank 0's new positions each iteration;
``replica_gap`` is the largest gap that closed, and ``run_layout`` raises
when it exceeds REPLICA_GAP_LIMIT: ranks that drew different samples or
started apart are an error, not rounding for the broadcast to absorb.

On the cards ``run_layout`` runs as the single-card engine's does: the
first iteration eagerly (it builds the kernels, creates the NCCL
communicators and, for 'ring_pallas', K3's peer regions), then one
iteration, the sample and the sharded step with all of its collectives, is
captured as a CUDA graph and replayed; every rank captures and replays the
same sequence. The replica gap lives on the card and is read once, at the
end of ``run_layout`` (the eager CPU loop reads it at every block's end).
Both ref orders run here; the auto order is 'row', as the JAX package
picks slot order only on a TPU.
"""

import numpy as np
import torch

from ..models.embedder import _COUNTED_KERNELS, GraphEmbedderTorch, \
    resolve_device
from .mesh import default_mesh
from .ring_binfold import ring_fold
from .sharded_step import (
    KNN_COMMS,
    REPLICA_GAP_LIMIT,
    build_sharded_step,
    pad_edges,
)


class ShardedGraphEmbedder(GraphEmbedderTorch):
    """Edge-partitioned embedder over the ranks of a mesh.

    mesh : parallel.mesh.Mesh, optional — default: every rank of the
        initialized process group, or a one-rank mesh on ``device`` without
        one. The engine computes on the mesh's device for this rank.
    knn_comm : None | 'all_gather' | 'all_to_all' | 'ring' | 'ring_pallas'
        — how the ranks' kNN candidates are merged (build_sharded_step).
    use_binfold_local : None | bool — the bin-fold kernel for the local
        top-k; None decides by the mesh's platform and the tile size.
    Other arguments as GraphEmbedderTorch; ``device`` must agree with the
    mesh's device type when both are given.
    """

    def __init__(self, adjacency, n_components=2, mesh=None, knn_comm=None,
                 use_binfold_local=None, device=None, seed=None, **kwargs):
        if knn_comm is not None and knn_comm not in KNN_COMMS:
            raise ValueError(f"Unknown knn_comm: {knn_comm!r}")
        if mesh is None:
            mesh = default_mesh(resolve_device(device))
        elif device is not None and resolve_device(device).type != \
                mesh.device.type:
            raise ValueError(
                f"device={device!r} disagrees with the mesh's device "
                f"{mesh.device}"
            )
        self.mesh = mesh
        self._n_mesh_devices = mesh.world_size
        self.knn_comm = knn_comm
        self.use_binfold_local = use_binfold_local
        if seed is None and mesh.world_size > 1:
            seed = mesh.broadcast_object(
                int(np.random.SeedSequence().entropy % (2**31))
            )
        super().__init__(adjacency, n_components=n_components,
                         device=mesh.device, seed=seed, **kwargs)

    # K3's launches (ring_fold.launches counts both of its entries) are
    # added per replay as well. The capture is thread-local, so that the
    # process group's watchdog thread, which may query the events of
    # earlier collectives meanwhile, cannot invalidate it; a synchronizing
    # call in the captured step itself still fails the capture
    _counted_kernels = _COUNTED_KERNELS + (ring_fold,)
    _capture_error_mode = "thread_local"

    def _resolved_strategy(self):
        return "sharded"

    def _init_mesh(self):
        """The Chebyshev init row-shards its SpMV over the engine's mesh."""
        return self.mesh

    def _build_step(self, edges_engine):
        """Pad the edge list to the mesh and bind the sharded step."""
        edges_p, valid = pad_edges(np.asarray(edges_engine, np.int32),
                                   self._n_mesh_devices)
        self._edges_padded = torch.as_tensor(edges_p, device=self.device).long()
        self._valid = torch.as_tensor(valid, device=self.device)
        _, _, step_ops, raw_step = build_sharded_step(
            self.mesh,
            self.n,
            self.n_edges,
            n_components=self.n_components,
            k_attr=self.k_attr,
            L_min=self.L_min,
            k_inter=self.k_inter,
            n_neighbors=self.n_neighbors,
            sample_size=self.sample_size,
            nb=self._nb,
            knn_recall_target=self.knn_recall_target,
            fused_refs=self.fused_midpoints,
            knn_comm=self.knn_comm,
            use_binfold_local=self.use_binfold_local,
            packed_gather=self.packed_gather,
            return_raw=True,
        )
        self._step_ops = step_ops
        self._sharded_raw = raw_step
        self._fused_refs_active = "bref_valid" in step_ops
        # every rank starts from rank 0's positions
        self.mesh.broadcast(self._positions, src=0)

    def _raw_step(self, positions, sampled):
        return self._sharded_raw(positions, self._edges_padded, self._valid,
                                 sampled, self._step_ops)

    @property
    def replica_gap(self):
        """Largest gap between this rank's own new positions and rank 0's,
        relative to the largest |position|, over the steps so far (0.0 on
        one rank)."""
        gap = self._step_ops.get("replica_gap")
        return 0.0 if gap is None else float(gap)

    def _sync(self):
        super()._sync()
        self._check_replica_gap()

    def run_layout(self, num_iterations=100, block_size=10, progress=False):
        """GraphEmbedderTorch.run_layout, then the replica-gap check (one
        host read of the device-held gap per call under replay)."""
        positions = super().run_layout(num_iterations, block_size, progress)
        self._check_replica_gap()
        return positions

    def _check_replica_gap(self):
        """Raises when this rank's own update left rank 0's by more than
        REPLICA_GAP_LIMIT."""
        gap = self.replica_gap
        if gap > REPLICA_GAP_LIMIT:
            raise RuntimeError(
                f"rank {self.mesh.rank}'s positions left rank 0's by "
                f"{gap:.3g} of their scale (limit {REPLICA_GAP_LIMIT:.3g}): "
                "the ranks' replicated inputs differ"
            )

    def __repr__(self):
        return (
            f"ShardedGraphEmbedder(n_vertices={self.n}, "
            f"n_components={self.n_components}, "
            f"mesh={dict(self.mesh.shape)}, device={self.device})"
        )


ShardedGraphEmbedderTorch = ShardedGraphEmbedder
