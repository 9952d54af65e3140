"""GraphEmbedderTorch: the force-directed layout engine in PyTorch.

Counterpart of ``graphem_rapids_tpu/models/embedder.py`` (GraphEmbedderTPU),
with the same constructor surface. Each iteration (``_raw_step``):

1. sample S edges;
2. spring forces from the neighbor-table gather, plus hub overflow;
3. edge-midpoint kNN refs fused from the same gather;
4. (k+1)-NN of the sampled midpoints against all midpoints, self column
   dropped; above EXACT_MAX_REFS on CUDA this is the bin-fold kernel
   (the 'approx' tier outside its gates), and knn_strategy='pallas'
   takes the exact tiled kernel;
5. intersection repulsion;
6. add the forces, center, divide by the ddof=1 std.

The step is a plain function on tensors. On a CUDA device ``run_layout``
runs it as JAX's ``multi_step`` runs its fused blocks: one iteration
(the sample, then the step into a static positions buffer) is captured as
a CUDA graph and replayed for every iteration, with no host sync until the
positions are read (or a progress bar is shown). On the CPU the same loop
runs eagerly. Randomness comes from an explicit ``torch.Generator`` seeded
from ``seed``; its numbers differ from jax.random's, so parity tests inject
the sample indices (``update_positions(sample_indices=...)``).
"""

import logging

import numpy as np
import scipy.sparse as sp
import torch

from .. import native as fg
from ..convert import state_from_jax
from ..ops import knn_binfold as bf
from ..ops import knn_pallas as kp
from ..ops.forces import (
    build_neighbor_table,
    build_neighbor_table_binned,
    intersection_forces,
    midpoint_refs_binned,
    spring_forces_binned,
    spring_refs_binned_slotwise,
    table_buckets,
)
from ..ops.knn import EXACT_MAX_REFS, knn, oneshot_budget_bytes
from ..ops.laplacian import spectral_init
from ..ops.sampling import sample_indices
from ..ops.segment import segment_sum, segment_sum_cluster, sort_tiles
from ..utils import tracing
from ..utils.memory_management import get_optimal_chunk_size

logger = logging.getLogger(__name__)

EPS = 1e-6

# The kernel wrappers whose ``launches`` count launches on the card: K1,
# K2 and the force accumulator's cluster kernel, sum and tile sort, the
# kernels a single-card step can launch.
# A replay launches what the capture recorded, so the engine adds the
# capture's count per replay.
_COUNTED_KERNELS = (bf.knn_binfold, kp.knn_pallas, segment_sum_cluster,
                    segment_sum, sort_tiles)


def resolve_device(device):
    """``torch.device`` for ``device``; None means CUDA, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphem_rapids_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev


def csr_upper_edges(adjacency, native=True):
    """Upper-triangle (i<j) COO edges of a sparse adjacency, (E, 2) int32 in
    row-major order; explicit zeros are excluded, as ``nonzero()`` would.

    The threaded C scan of the CSR structure (native.csr_lt_edges_native)
    runs under the JAX package's guards: no explicit zero, n < 2^31, int32
    or int64 indices. Outside them, or with ``native=False``, the numpy
    line (csr_lt_edges_plain) does, with the same result.
    """
    if adjacency.format != "csr":
        adjacency = adjacency.tocsr()
    n = adjacency.shape[0]
    nz = adjacency.data != 0
    keep = None if nz.all() else nz
    if native and keep is None and n < 2**31:
        edges = fg.csr_lt_edges_native(adjacency.indptr, adjacency.indices, n)
        if edges is not None:
            return edges
    return fg.csr_lt_edges_plain(adjacency.indptr, adjacency.indices, n, keep)


class GraphEmbedderTorch:
    """Force-directed graph embedder on a CUDA device (PyTorch).

    Parameters follow GraphEmbedderTPU:

    adjacency : array-like or scipy.sparse matrix, square (n x n).
    n_components : int, default=2 — embedding dimensionality.
    device : None, str or torch.device — None selects CUDA and raises when
        there is none; pass 'cpu' explicitly to run on the CPU.
    dtype : torch dtype, default=torch.float32.
    L_min, k_attr, k_inter : spring length, attraction, repulsion constants.
    n_neighbors : int, default=10 — neighbors per sampled midpoint.
    sample_size : int, default=256 — midpoints sampled per iteration.
    batch_size : int, optional — ref tile of the 'chunked' kNN strategy;
        None derives it from the device budget with get_optimal_chunk_size,
        as GraphEmbedderTPU does.
    knn_strategy : 'auto' | 'exact' | 'chunked' | 'approx' | 'binfold' |
        'pallas'. 'auto' is exact up to EXACT_MAX_REFS edges; beyond, CUDA
        takes the bin-fold kernel while its gates hold (dim <= 8,
        k+1 <= 48, edges below MAX_REFS_SEGMENTED) and 'approx' otherwise,
        the CPU 'chunked'. 'approx' is the JAX package's tier as it runs
        off a TPU: one-shot distances and an exact top-k while they fit
        ops/knn.py's oneshot_budget_bytes, the chunked scan beyond.
        'pallas' is the exact tiled kernel (k+1 <= 128); 'auto' never
        selects it.
    knn_compute_dtype : torch dtype or None — the dtype of the 'approx'
        tier's one-shot distances (e.g. torch.bfloat16); None is float32,
        as the JAX package's default off a TPU.
    knn_recall_target : float, default=0.95 — sizes the bin-fold bins.
    init : 'auto' | 'scipy' | 'chebyshev' | 'lobpcg' | 'random'
        (ops/laplacian.py). 'auto' is host ARPACK below 500,000 vertices
        and the Chebyshev tier on the engine's device from there on.
    fused_midpoints : bool, optional — build the kNN refs from the spring
        gather; None enables it for 'binfold' and 'approx' while the ref
        slot count stays within 4E (and, for 'approx', while S x the ref
        slot count x 4 bytes fits oneshot_budget_bytes).
    binned_table : bool, optional — degree-binned tables; None lets the
        bucket cost model decide, True forces them, False keeps the flat one.
    ref_order : None | 'row' | 'slot' — the enumeration of the kNN ref
        space (ops/forces.py build_neighbor_table). None is 'row', as the
        JAX package chooses off a TPU; 'slot' builds slot-major tables and
        runs the slotwise spring/ref ops, so the kNN sees the refs in the
        JAX package's slot order.
    packed_gather : accepted; a value-identical no-op here.
    memory_efficient, verbose, logger_instance : as in GraphEmbedderTPU.
    seed : int, optional — seeds the sampling generator and the init.
    """

    def __init__(
        self,
        adjacency,
        n_components=2,
        device=None,
        dtype=torch.float32,
        L_min=1.0,
        k_attr=0.2,
        k_inter=0.5,
        n_neighbors=10,
        sample_size=256,
        batch_size=None,
        knn_strategy="auto",
        knn_compute_dtype=None,
        knn_recall_target=0.95,
        init="auto",
        fused_midpoints=None,
        binned_table=None,
        ref_order=None,
        packed_gather=None,
        memory_efficient=True,
        verbose=True,
        logger_instance=None,
        seed=None,
    ):
        if logger_instance is not None:
            self.logger = logger_instance
        else:
            self.logger = logger
            if verbose:
                logging.basicConfig(level=logging.INFO)

        adjacency = self._validate_adjacency(adjacency)
        self.adjacency = adjacency
        self.n = adjacency.shape[0]
        self.n_components = int(n_components)
        self.dtype = dtype
        self.L_min = float(L_min)
        self.k_attr = float(k_attr)
        self.k_inter = float(k_inter)
        self.n_neighbors = int(n_neighbors)
        self.memory_efficient = memory_efficient
        self.verbose = verbose
        self.seed = seed
        self.knn_strategy = knn_strategy
        self.knn_compute_dtype = knn_compute_dtype
        self.knn_recall_target = float(knn_recall_target)
        self.fused_midpoints = fused_midpoints
        self.binned_table = binned_table
        self.packed_gather = packed_gather
        self._iteration = 0

        if self.n_components <= 0:
            raise ValueError(
                f"Number of components must be positive, got {n_components}"
            )
        if self.k_attr < 0:
            raise ValueError(
                f"Attractive force constant k_attr must be non-negative, "
                f"got {k_attr}"
            )
        if self.n_neighbors <= 0:
            raise ValueError(
                f"n_neighbors must be positive, got {n_neighbors}"
            )
        if sample_size <= 0:
            raise ValueError(f"sample_size must be positive, got {sample_size}")
        if ref_order not in (None, "row", "slot"):
            raise ValueError(f"unknown ref_order: {ref_order!r}")
        self.ref_order = ref_order or "row"
        self._graph = None

        self.device = resolve_device(device)
        with tracing.span("setup"):
            self._set_up(adjacency, sample_size, batch_size, init, seed)

    def _set_up(self, adjacency, sample_size, batch_size, init, seed):
        """The set-up's stages, each a span: the edges, the tables, the
        spectral start, and the upload (the step's tensors)."""
        with tracing.span("setup.edges"):
            edges_np = self._extract_edges_from_adjacency(adjacency)
        self.n_edges = len(edges_np)
        self.sample_size = int(min(sample_size, max(self.n_edges, 1)))
        self._edges_np = edges_np
        self._strategy = self._resolved_strategy()
        if (self._strategy == "pallas"
                and min(self.n_neighbors + 1, self.n_edges) > kp.MAX_K):
            raise ValueError(
                f"knn_strategy='pallas' supports k <= {kp.MAX_K}, got "
                f"n_neighbors + 1 = {self.n_neighbors + 1}"
            )
        if batch_size is None:
            self.batch_size = get_optimal_chunk_size(
                self.n, self.n_components, strategy=self._strategy,
                device=self.device,
            )
        else:
            self.batch_size = int(batch_size)

        # Keep the ref space inside the bin-fold kernel's segmented index
        # bound on the card (binds only at ~100M-edge scale).
        ref_budget = (
            bf.MAX_REFS_SEGMENTED - 1 if self.device.type == "cuda" else None
        )
        binned_table = self.binned_table
        want_binned = True if binned_table is None else bool(binned_table)
        with tracing.span("setup.tables"):
            nbb = (
                build_neighbor_table_binned(
                    edges_np, self.n,
                    overhead_rows=0 if binned_table else 4096,
                    ref_order=self.ref_order, ref_budget=ref_budget,
                )
                if want_binned and self.n_edges > 0 else None
            )
            if nbb is None:
                self._nb = build_neighbor_table(edges_np, self.n,
                                                ref_order=self.ref_order,
                                                ref_budget=ref_budget)
        if nbb is not None:
            self._nb = nbb
            self._perm = nbb["perm"]
            self._inv_perm = nbb["inv_perm"]
            self._edge_map = nbb["edge_map"]
            edges_engine = nbb["edges_int"]
        else:
            self._perm = None
            self._inv_perm = None
            self._edge_map = None
            edges_engine = edges_np
        self._base_seed = int(
            seed if seed is not None
            else np.random.SeedSequence().entropy % (2**31)
        )
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._base_seed)

        if self.verbose:
            self.logger.info("Initialized GraphEmbedderTorch on %s", self.device)
            self.logger.info("Graph: %d vertices, %d edges, %dD",
                             self.n, self.n_edges, self.n_components)
            self.logger.info("Neighbor table: %s", self.table_kind)
            self.logger.info("kNN strategy: %s", self._strategy)
            self.logger.info("kNN batch size: %d", self.batch_size)

        with tracing.span("setup.spectral"):
            init_np = spectral_init(adjacency, self.n_components,
                                    method=init, seed=seed,
                                    device=self.device,
                                    mesh=self._init_mesh())
        with tracing.span("setup.upload"):
            if self._perm is not None:
                init_np = init_np[self._perm]
            self._positions = torch.as_tensor(init_np, dtype=self.dtype,
                                              device=self.device)
            self._build_step(edges_engine)

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #

    def _init_mesh(self):
        """The mesh the Chebyshev init row-shards over: none here."""
        return None

    def _validate_adjacency(self, adjacency):
        """Validate and convert to CSR."""
        if sp.issparse(adjacency):
            adjacency = adjacency.tocsr()
        elif not isinstance(adjacency, np.ndarray):
            adjacency = np.asarray(adjacency)
        if adjacency.ndim != 2 or adjacency.shape[0] != adjacency.shape[1]:
            raise ValueError(
                f"Adjacency matrix must be square, got shape {adjacency.shape}"
            )
        if adjacency.shape[0] == 0:
            raise ValueError("Adjacency matrix cannot be empty")
        if not sp.issparse(adjacency):
            adjacency = sp.csr_matrix(adjacency)
        return adjacency

    def _extract_edges_from_adjacency(self, adjacency):
        """Upper-triangle (i<j) COO edges from the CSR structure, int32
        (csr_upper_edges)."""
        edges = csr_upper_edges(adjacency)
        if self.verbose and len(edges) == 0:
            self.logger.warning("No edges found in adjacency matrix")
        return edges

    def _resolved_strategy(self):
        if self.knn_strategy != "auto":
            return self.knn_strategy
        if self.n_edges <= EXACT_MAX_REFS:
            return "exact"
        if self.device.type == "cuda":
            k_eff = min(self.n_neighbors + 1, max(self.n_edges, 1))
            if (self.n_components <= bf.MAX_DIM and k_eff <= bf.MAX_K
                    and self.n_edges < bf.MAX_REFS_SEGMENTED):
                return "binfold"
            # outside the bin-fold gates, as the JAX package does
            return "approx"
        # the exact blockwise scan on the CPU, as the JAX package's
        return "chunked"

    @property
    def table_kind(self):
        """'binned' or 'flat', plus '+overflow plan' when one is active."""
        kind = "binned" if "buckets" in self._nb else "flat"
        if self._nb.get("overflow_plan") is not None:
            kind += "+overflow plan"
        return kind

    def _build_step(self, edges_engine):
        """Move the tables to the device and fix the step's static choices."""
        nb = self._nb
        dev = self.device
        E = self.n_edges

        def put(a):
            return torch.as_tensor(np.asarray(a), device=dev).long()

        self._k_eff = min(self.n_neighbors + 1, E)
        n_ref_slots = int(len(nb["ref_edge"]))
        if self.fused_midpoints is None:
            # while the padded slot count stays bounded and the enlarged
            # ref set fits the strategy: the kernel's index bound for
            # 'binfold', the one-shot distance budget for 'approx'
            if self._strategy == "binfold":
                budget_ok = n_ref_slots < bf.MAX_REFS_SEGMENTED
            else:
                budget_ok = (self.sample_size * n_ref_slots * 4
                             <= oneshot_budget_bytes(dev))
            self._fused_refs_active = (
                self._strategy in ("approx", "binfold")
                and E > 0
                and n_ref_slots <= 4 * E
                and budget_ok
            )
        else:
            self._fused_refs_active = bool(self.fused_midpoints) and E > 0

        ops = {
            "edges": put(edges_engine).reshape(-1, 2),
            "ref_edge": put(nb["ref_edge"]),
            "ref_valid": torch.as_tensor(nb["ref_valid"], device=dev),
            "edge_ref": put(nb["edge_ref"]),
            "overflow_lt": (
                put(nb["overflow_lt"]) if len(nb["overflow_lt"]) else None
            ),
            "nb_overflow": None,
            "ov_plan": None,
        }
        # slot order keeps each table transposed, (cap, rows); a flat
        # table is one bucket and has no renumbering
        key = "table_t" if nb["ref_order"] == "slot" else "table"
        ops["buckets"] = table_buckets(nb)
        ops["tables"] = [put(g[key]) for g in ops["buckets"]]
        ops["edge_order"] = (
            put(nb["edge_user"]) if "edge_user" in nb else None
        )
        plan = nb.get("overflow_plan")
        if plan is not None:
            ops["ov_plan"] = {
                "pairs": put(plan["pairs"]),
                "block_hub": put(plan["block_hub"]),
                "hub_ids": put(plan["hub_ids"]),
                "block": plan["block"],
            }
        elif len(nb["overflow"]):
            ops["nb_overflow"] = put(nb["overflow"])
        self._ops = ops

    # ------------------------------------------------------------------ #
    # the layout step
    # ------------------------------------------------------------------ #

    def _raw_step(self, positions, sampled):
        """One layout iteration on ``positions`` with sampled edge ids
        (engine numbering); returns the new positions."""
        ops = self._ops
        nb = self._nb
        buckets = ops["buckets"]
        k_attr, L_min = self.k_attr, self.L_min
        k_eff = self._k_eff
        fused = self._fused_refs_active and k_eff > 1
        # the stage spans record only while this runs in Python (eagerly,
        # at a capture, on the CPU), not under graph replay; in slot order
        # the refs come with the spring's gathers (step.spring)
        with tracing.span("step.spring"):
            if nb["ref_order"] == "slot":
                # per-slot (rows, d) gathers shared by the spring sum and
                # the slot-major ref set
                spring, refs = spring_refs_binned_slotwise(
                    positions, ops["tables"], buckets, k_attr, L_min,
                    ref_valid=ops["ref_valid"],
                    overflow_lt=ops["overflow_lt"],
                    overflow_edges=ops["nb_overflow"],
                    overflow_plan=ops["ov_plan"], want_refs=fused,
                )
            else:
                pn_list = [positions[t] for t in ops["tables"]]
                spring = spring_forces_binned(
                    positions, pn_list, buckets, k_attr, L_min,
                    ops["nb_overflow"], ops["ov_plan"],
                )
        if fused and nb["ref_order"] != "slot":
            with tracing.span("step.refs"):
                refs = midpoint_refs_binned(
                    positions, pn_list, buckets, ops["ref_valid"],
                    ops["overflow_lt"],
                )
        if k_eff > 1:
            kw = dict(strategy=self._strategy, chunk_size=self.batch_size,
                      compute_dtype=self.knn_compute_dtype,
                      recall_target=self.knn_recall_target)
            with tracing.span("step.knn"):
                if fused:
                    queries = refs[ops["edge_ref"][sampled.long()]]
                    slot_idx, _ = knn(queries, refs, k_eff, **kw)
                    # drop self
                    knn_idx = ops["ref_edge"][slot_idx[:, 1:].long()]
                else:
                    edges = ops["edges"]
                    midpoints = (positions[edges[:, 0]]
                                 + positions[edges[:, 1]]) / 2.0
                    knn_idx, _ = knn(midpoints[sampled.long()], midpoints,
                                     k_eff, **kw)
                    knn_idx = knn_idx[:, 1:]  # drop self column
            with tracing.span("step.intersect"):
                inter = intersection_forces(
                    positions, ops["edges"], knn_idx, sampled, self.k_inter,
                    edge_order=ops["edge_order"],
                )
        else:
            # a single edge has no neighbor edges to intersect
            inter = torch.zeros_like(positions)
        with tracing.span("step.update"):
            new_positions = positions + spring + inter
            new_positions = new_positions - new_positions.mean(dim=0,
                                                               keepdim=True)
            std = new_positions.std(dim=0, keepdim=True, unbiased=True) + EPS
            return new_positions / std

    def _sample(self):
        return sample_indices(self._generator, self.n_edges,
                              self.sample_size, device=self.device)

    # ------------------------------------------------------------------ #
    # fused blocks: CUDA-graph replay (JAX's multi_step)
    # ------------------------------------------------------------------ #

    @property
    def _fused_blocks(self):
        """Whether iterations drawn from the generator replay a CUDA graph:
        on a card; the CPU runs them eagerly, as there is no graph there."""
        return self.device.type == "cuda"

    # the kernel wrappers whose launches a replay adds (``launches``), and
    # the capture's error mode (torch.cuda.graph): 'global' refuses, in any
    # thread, a CUDA call that is unsafe during the capture
    _counted_kernels = _COUNTED_KERNELS
    _capture_error_mode = "global"

    def _store(self, positions):
        """Make ``positions`` the engine's: copied into the captured graph's
        static buffer once there is a graph, so that no set position is
        lost under it."""
        if self._graph is None:
            self._positions = positions
        else:
            self._positions.copy_(positions)

    def _capture(self):
        """Capture one iteration, the sample from the engine's generator
        and the step into the static buffer ``self._positions``.

        The generator is registered with the graph, so that each replay
        draws at its current Philox offset and advances it as an eager draw
        would. The capture itself draws nothing and launches nothing: the
        kernel counters' increase during it is taken back and added once
        per replay instead.
        """
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            graph.register_generator_state(self._generator)
        counted = self._counted_kernels
        before = [fn.launches for fn in counted]
        try:
            with torch.cuda.graph(graph,
                                  capture_error_mode=self._capture_error_mode):
                sampled = self._sample()
                self._positions.copy_(self._raw_step(self._positions,
                                                     sampled))
        finally:
            per_replay = [fn.launches - b for fn, b in zip(counted, before)]
            for fn, b in zip(counted, before):
                fn.launches = b
        self._graph = graph
        self._graph_launches = list(zip(counted, per_replay))
        # the graph's sample buffer: the last replayed iteration's sample
        self._graph_sample = sampled

    def _replay(self, n):
        """``n`` iterations drawn from the generator, by graph replay.

        Before the first capture one of them runs eagerly: it builds the
        kernels, queries their occupancy and creates the library handles
        outside the capture, and it is a real iteration of the trajectory.
        Nothing here synchronizes with the host.
        """
        if n <= 0:
            return
        if self._graph is None:
            with tracing.span("layout.first_step"):
                self._positions = self._raw_step(self._positions,
                                                 self._sample())
            n -= 1
            with tracing.span("layout.capture"):
                self._capture()
        with tracing.span("layout.replay"):
            for _ in range(n):
                self._graph.replay()
        for fn, per_replay in self._graph_launches:
            fn.launches += per_replay * n

    def _iterate(self, n):
        """``n`` iterations drawn from the engine's generator."""
        if self._fused_blocks:
            self._replay(n)
            return
        for _ in range(n):
            self._positions = self._raw_step(self._positions, self._sample())

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    @property
    def positions(self):
        """Positions as a host numpy array, in USER vertex order.

        Spans: ``layout.read.wait`` (the device finishing the work queued
        before the read), ``layout.read.copy`` (to the host) and
        ``layout.read.permute`` (to user order), under ``layout.read``.
        """
        with tracing.span("layout.read"):
            with tracing.span("layout.read.wait"):
                if self._positions.is_cuda:
                    torch.cuda.current_stream(
                        self._positions.device).synchronize()
            with tracing.span("layout.read.copy"):
                pos = self._positions.detach().cpu().numpy()
            with tracing.span("layout.read.permute"):
                if self._perm is not None:
                    pos = pos[self._inv_perm]
            return pos

    @positions.setter
    def positions(self, value):
        value = np.asarray(value)
        if self._perm is not None:
            value = value[self._perm]
        self._store(torch.tensor(value, dtype=self.dtype, device=self.device))

    def get_positions(self):
        """Positions as a numpy array."""
        return self.positions

    def update_positions(self, sample_indices=None):
        """Run one layout iteration.

        sample_indices : optional (S,) int array of USER edge ids — inject
        the midpoint sample (parity-testing hook); the step then runs
        eagerly, as JAX's separate ``_raw_step`` jit does. When None, the
        sample is drawn from the engine's generator by the same replayed
        graph as run_layout's on a card.
        """
        if self.n_edges == 0:
            return
        if sample_indices is None:
            self._iterate(1)
        else:
            sampled = np.asarray(sample_indices)
            if self._edge_map is not None:
                # the binned engine renumbers edges internally
                sampled = self._edge_map[sampled]
            sampled = torch.as_tensor(sampled, device=self.device).to(torch.int32)
            self._store(self._raw_step(self._positions, sampled))
        self._iteration += 1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_layout(self, num_iterations=100, block_size=10, progress=False):
        """Run the force-directed layout; returns the final positions.

        Iterations run in blocks of ``block_size``, with one progress
        update per block. On a card each iteration replays one captured
        CUDA graph (the first one runs eagerly, then the capture; see
        ``_replay``), and the host waits for the device only to advance a
        progress bar and when the final positions are read. Capture or
        replay errors raise: the CUDA path never falls back to the eager
        loop, which is the CPU's.
        """
        with tracing.span("layout.call"):
            if self.verbose:
                self.logger.info("Running layout for %d iterations",
                                 num_iterations)
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            if self.n_edges == 0:
                return self.positions
            bar = None
            if progress:
                try:
                    from tqdm import tqdm

                    bar = tqdm(total=num_iterations, desc="layout",
                               unit="iter")
                except ImportError:
                    pass
            done = 0
            while done < num_iterations:
                n = min(block_size, num_iterations - done)
                self._iterate(n)
                done += n
                self._iteration += n
                if bar is not None or not self._fused_blocks:
                    # the bar tracks the device, not the launch queue; the
                    # eager tiers sync per block as before
                    self._sync()
                if bar is not None:
                    bar.update(n)
                if self.verbose:
                    self.logger.info("Completed iteration %d/%d", done,
                                     num_iterations)
            if bar is not None:
                bar.close()
            return self.positions

    def save_checkpoint(self, path):
        """Save layout state to an .npz: positions (user order), the torch
        generator state, the iteration, and the graph shape."""
        np.savez(
            path,
            positions=self.positions,
            rng_state=self._generator.get_state().numpy(),
            iteration=self._iteration,
            n=self.n,
            n_components=self.n_components,
            n_edges=self.n_edges,
        )

    def load_checkpoint(self, path_or_state):
        """Restore layout state from a path or a state dict.

        Takes this engine's own checkpoints, checkpoints written by
        ``GraphEmbedderTPU.save_checkpoint`` and the dict of
        ``convert.state_from_jax``. A JAX PRNG key cannot become a torch
        generator state, so for a JAX state the generator is reseeded
        deterministically from the engine's seed and the iteration.
        Raises ValueError when the graph shape does not match.
        """
        if isinstance(path_or_state, dict):
            data = path_or_state
        else:
            with np.load(path_or_state) as npz:
                data = {k: npz[k] for k in npz.files}
        if "rng_state" not in data:
            data = state_from_jax(data)
        if int(data["n"]) != self.n or int(data["n_edges"]) != self.n_edges:
            raise ValueError(
                f"Checkpoint graph mismatch: checkpoint has n={int(data['n'])}"
                f"/E={int(data['n_edges'])}, embedder has n={self.n}"
                f"/E={self.n_edges}"
            )
        if int(data["n_components"]) != self.n_components:
            raise ValueError(
                f"Checkpoint n_components={int(data['n_components'])} != "
                f"{self.n_components}"
            )
        self.positions = data["positions"]
        self._iteration = int(data["iteration"])
        if "rng_state" in data:
            self._generator.set_state(
                torch.as_tensor(np.asarray(data["rng_state"], np.uint8))
            )
        else:
            self._generator.manual_seed(self._base_seed + self._iteration)

    def display_layout(self, edge_width=1, node_size=3, node_colors=None):
        """Plotly 2D/3D scatter of the embedding and its edges; requires
        plotly and raises ImportError with guidance without it."""
        from ..visualization import plot_layout

        plot_layout(
            self.positions,
            self._edges_np,
            edge_width=edge_width,
            node_size=node_size,
            node_colors=node_colors,
        )

    def __repr__(self):
        return (
            f"GraphEmbedderTorch(n_vertices={self.n}, "
            f"n_components={self.n_components}, device={self.device}, "
            f"knn_strategy={self._strategy!r})"
        )
