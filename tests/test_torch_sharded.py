"""The port's sharded tier against the JAX package's, on the CPU.

Four gloo ranks, spawned once for this file (``python <this file> --worker
RANK WORLD STORE OUT``, a file:// store under the test's tmp_path), run every
variant below: the same graph, start positions and injected samples, made
with numpy, go through ``ShardedGraphEmbedder`` on a 4-rank mesh, and each
rank writes its results to an .npz. The tests hold them against JAX
``ShardedGraphEmbedder(mesh=make_mesh(4))`` on the 8-device CPU mesh at
rtol=1e-4, atol=1e-5 after 5 steps (the force scatters sum in another order
than XLA's), and against each other: every rank bit-equal, and the 'ring'
and 'all_to_all' merges bit-equal to the port's own 'all_gather'. Every
rank's own update must equal rank 0's before the broadcast that makes
positions equal (a replica gap of exactly 0 on the CPU), run_layout must
draw one sample on every rank, and ranks given different samples must be
caught. The 'ring_pallas' neighbour sets (``_debug_knn``) must equal JAX's,
whose Pallas ring runs in interpret mode off the TPU. Slot-order tables
(``ref_order='slot'``, flat and binned) run the same checks, and the exact
merges' neighbour sets with slot order equal those with row order. The row-sharded
Chebyshev init must equal the single-rank runner and JAX's mesh modulo
column signs. One-rank meshes, without a process group, run in the test
process.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
STEPS = 5
PARAMS = dict(n_components=3, L_min=10.0, k_attr=0.5, k_inter=0.1,
              n_neighbors=5, sample_size=64, verbose=False, seed=7,
              init="random")


def regular_graph(n=300, cycles=3, seed=0):
    """Union of random Hamiltonian cycles: a flat table."""
    rng = np.random.default_rng(seed)
    e = []
    for _ in range(cycles):
        p = rng.permutation(n)
        e.append(np.column_stack([p, np.roll(p, -1)]))
    e = np.concatenate(e)
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


def hub_graph(n=400, seed=2):
    """Two hubs and random edges: binned tables with an overflow plan."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 300)] + [(1, j) for j in range(2, 200)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (700, 2)) if a != b]
    e = np.unique(np.array(sorted(set(e)), np.int64), axis=0)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1
    return a


GRAPHS = {"regular": regular_graph, "hub": hub_graph}
# name: (graph, engine kwargs) — every variant runs STEPS injected steps
VARIANTS = {
    "flat_all_gather": ("regular", dict(knn_comm="all_gather")),
    "flat_fused": ("regular", dict(fused_midpoints=True)),
    "flat_ring": ("regular", dict(knn_comm="ring")),
    "flat_all_to_all": ("regular", dict(knn_comm="all_to_all")),
    "hub_binned": ("hub", dict(binned_table=True)),
    "hub_binned_fused": ("hub", dict(binned_table=True,
                                     fused_midpoints=True)),
    "hub_binned_fused_ring": ("hub", dict(binned_table=True,
                                          fused_midpoints=True,
                                          knn_comm="ring")),
    "hub_binned_fused_all_to_all": ("hub", dict(binned_table=True,
                                                fused_midpoints=True,
                                                knn_comm="all_to_all")),
    # slot-major tables: transposed, column-sharded, slot-major local refs
    "flat_slot_unfused": ("regular", dict(ref_order="slot")),
    "flat_slot": ("regular", dict(ref_order="slot", fused_midpoints=True)),
    "flat_slot_ring": ("regular", dict(ref_order="slot", fused_midpoints=True,
                                       knn_comm="ring")),
    "flat_slot_all_to_all": ("regular", dict(ref_order="slot",
                                             fused_midpoints=True,
                                             knn_comm="all_to_all")),
    "hub_binned_slot": ("hub", dict(binned_table=True, fused_midpoints=True,
                                    ref_order="slot")),
    "hub_binned_slot_ring": ("hub", dict(binned_table=True,
                                         fused_midpoints=True,
                                         ref_order="slot", knn_comm="ring")),
    "hub_binned_slot_all_to_all": ("hub", dict(binned_table=True,
                                               fused_midpoints=True,
                                               ref_order="slot",
                                               knn_comm="all_to_all")),
}
# knn_comm variants and the all_gather variant they must equal bit for bit
SAME_AS = {
    "flat_ring": "flat_all_gather",
    "flat_all_to_all": "flat_all_gather",
    "hub_binned_fused_ring": "hub_binned_fused",
    "hub_binned_fused_all_to_all": "hub_binned_fused",
    "flat_slot_ring": "flat_slot",
    "flat_slot_all_to_all": "flat_slot",
    "hub_binned_slot_ring": "hub_binned_slot",
    "hub_binned_slot_all_to_all": "hub_binned_slot",
}
# ring_pallas _debug_knn cases: (graph, fused refs, ref order)
KNN_CASES = {"knn_unfused": ("regular", False, "row"),
             "knn_fused": ("regular", True, "row"),
             "knn_slot_fused": ("regular", True, "slot")}
# the exact merges' _debug_knn neighbour sets with fused refs in both ref
# orders: (ref order, knn_comm)
ORDER_KNN_CASES = {f"knn_{order}_{comm}": (order, comm)
                   for order in ("row", "slot")
                   for comm in ("all_gather", "all_to_all", "ring")}
# use_approx_local=True steps through build_sharded_step: (fused refs,
# knn_comm); JAX's ShardedGraphEmbedder takes no use_approx_local either
APPROX_LOCAL_CASES = {"approx_local": (False, "all_gather"),
                      "approx_local_fused_ring": (True, "ring")}
CKPT_VARIANT = "hub_binned_fused"
# row-sharded Chebyshev init cases: (graph, n_components); the graphs of
# tests/test_spectral_chebyshev.py, 1999 leaving a padded tail on 4 ranks
CHEB_CASES = {
    "cheb_regular_2000": ("regular_2000", 3),
    "cheb_regular_1999": ("regular_1999", 3),
    "cheb_overflow": ("star_ring_chords", 2),
}
# two ranks, where each rank's left and right neighbour are the same peer
TWO_RANK_VARIANTS = ("flat_all_gather", "flat_ring", "hub_binned_fused",
                     "hub_binned_fused_all_to_all", "flat_slot",
                     "flat_slot_ring", "hub_binned_slot",
                     "hub_binned_slot_all_to_all")


def cheb_graph(name):
    """A Chebyshev case's graph (networkx, as the JAX tests build it)."""
    import networkx as nx

    if name == "star_ring_chords":
        G = nx.star_graph(800)
        G.add_edges_from((i, (i + 1) % 801) for i in range(1, 800))
        G.add_edges_from((i, (i + 37) % 801) for i in range(1, 800))
    else:
        G = nx.random_regular_graph(8, int(name.split("_")[1]), seed=0)
    return sp.csr_matrix(nx.adjacency_matrix(G, dtype=int))


def start_positions(n):
    return np.random.default_rng(11).standard_normal((n, 3)).astype(
        np.float32)


def samples(n_edges, steps=STEPS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.permutation(n_edges)[:PARAMS["sample_size"]]
            for _ in range(steps)]


def _engine_edges(adj):
    rows, cols = adj.nonzero()
    mask = rows < cols
    return np.column_stack([rows[mask], cols[mask]]).astype(np.int64)


def _debug_knn_inputs(graph, ref_order="row"):
    """(n, E, edges, flat table, positions, sample) of a _debug_knn case."""
    from graphem_rapids_torch.ops.forces import build_neighbor_table

    adj = GRAPHS[graph]()
    edges = _engine_edges(adj)
    n, E = adj.shape[0], len(edges)
    nb = build_neighbor_table(edges, n, ref_order=ref_order)
    return n, E, edges, nb, start_positions(n), samples(E, steps=1)[0]


def _approx_local_kw(fused, knn_comm):
    return dict(n_components=3, k_attr=0.5, L_min=10.0, k_inter=0.1,
                n_neighbors=5, sample_size=64, knn_comm=knn_comm,
                fused_refs=fused, use_approx_local=True, return_raw=True)


def _debug_knn_kw(fused, knn_comm="ring_pallas", sample_size=128):
    """The ring_pallas cases take the sample's length from the queries; the
    exact merges' shards need ``sample_size`` equal to it."""
    return dict(n_components=3, k_attr=0.2, L_min=1.0, k_inter=0.5,
                n_neighbors=8, sample_size=sample_size, knn_comm=knn_comm,
                fused_refs=fused, _debug_knn=True, return_raw=True)


# ---------------------------------------------------------------------- #
# the gloo worker
# ---------------------------------------------------------------------- #

def _run_variant(mesh, graph, kw):
    from graphem_rapids_torch.parallel import ShardedGraphEmbedder

    adj = GRAPHS[graph]()
    emb = ShardedGraphEmbedder(adj, mesh=mesh, **PARAMS, **kw)
    emb.positions = start_positions(emb.n)
    for s in samples(emb.n_edges):
        emb.update_positions(sample_indices=s)
    return emb


def worker(rank, world, store, out):
    """Run every variant on one gloo rank and write ``out/rank<r>.npz``."""
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from graphem_rapids_torch.parallel import (
        ShardedGraphEmbedder,
        build_sharded_step,
        distributed_init,
        make_mesh,
        mesh_is_multiprocess,
        replicate_to_mesh,
    )
    from graphem_rapids_torch.parallel.sharded_step import pad_edges

    distributed_init(backend="gloo", init_method=f"file://{store}",
                     world_size=world, rank=rank)
    mesh = make_mesh(world)
    res = {"mesh": np.array([mesh.rank, mesh.world_size,
                             mesh_is_multiprocess(mesh)]),
           "replicated": replicate_to_mesh(np.full(3, rank), mesh).numpy()}
    names = VARIANTS if world == WORLD else TWO_RANK_VARIANTS
    for name in names:
        graph, kw = VARIANTS[name]
        emb = _run_variant(mesh, graph, kw)
        res[name] = emb.positions
        res[name + "/gap"] = np.array(emb.replica_gap)
        res[name + "/fused"] = np.array(emb._fused_refs_active)
        res[name + "/table"] = np.array(emb.table_kind)
        if name == CKPT_VARIANT and world == WORLD:
            path = Path(out) / f"ckpt{rank}.npz"
            emb.save_checkpoint(path)
            graph_adj = GRAPHS[graph]()
            back = ShardedGraphEmbedder(graph_adj, mesh=mesh,
                                        **dict(PARAMS, seed=99), **kw)
            back.load_checkpoint(path)
            res["ckpt/loaded"] = back.positions
            res["ckpt/iteration"] = np.array(back._iteration)
            emb.run_layout(2)
            back.run_layout(2)
            res["ckpt/continued"] = emb.positions
            res["ckpt/resumed"] = back.positions
    # generator-drawn samples, the seed drawn on rank 0 and broadcast
    emb = ShardedGraphEmbedder(GRAPHS["regular"](), mesh=mesh,
                               **dict(PARAMS, seed=None),
                               knn_comm="ring_pallas")
    emb.run_layout(3, block_size=3)
    res["run_layout"] = emb.positions
    res["run_layout/gap"] = np.array(emb.replica_gap)
    res["run_layout/next_sample"] = emb._sample().numpy()
    # each rank its own sample: the broadcast must not hide it
    emb = ShardedGraphEmbedder(GRAPHS["regular"](), mesh=mesh, **PARAMS)
    emb.positions = start_positions(emb.n)
    emb.update_positions(
        sample_indices=samples(emb.n_edges, steps=1, seed=20 + rank)[0])
    res["diverged/gap"] = np.array(emb.replica_gap)
    try:
        emb._sync()
        res["diverged/raised"] = np.array(False)
    except RuntimeError:
        res["diverged/raised"] = np.array(True)
    knn_cases = {name: (graph, fused, order, "ring_pallas")
                 for name, (graph, fused, order) in KNN_CASES.items()}
    knn_cases.update({name: ("regular", True, order, comm)
                      for name, (order, comm) in ORDER_KNN_CASES.items()})
    for name, (graph, fused, order, comm) in knn_cases.items():
        n, E, edges, nb, pos, sampled = _debug_knn_inputs(graph, order)
        edges_p, valid = pad_edges(edges, world)
        _, _, ops, raw = build_sharded_step(
            mesh, n, E, nb=nb, **_debug_knn_kw(
                fused, comm, 128 if comm == "ring_pallas" else len(sampled)))
        knn_idx, _ = raw(torch.from_numpy(pos), torch.from_numpy(
            edges_p).long(), torch.from_numpy(valid),
            torch.from_numpy(sampled), ops)
        res[name] = knn_idx.numpy()
    for name, (fused, comm) in APPROX_LOCAL_CASES.items():
        n, E, edges, nb, pos, _ = _debug_knn_inputs("regular")
        edges_p, valid = pad_edges(edges, world)
        _, _, ops, raw = build_sharded_step(mesh, n, E, nb=nb,
                                            **_approx_local_kw(fused, comm))
        pos = torch.from_numpy(pos)
        for s in samples(E):
            pos = raw(pos, torch.from_numpy(edges_p).long(),
                      torch.from_numpy(valid), torch.from_numpy(s), ops)
        res[name] = pos.numpy()
    if world == WORLD:
        from graphem_rapids_torch.ops.laplacian import _spectral_chebyshev

        for name, (graph, k) in CHEB_CASES.items():
            res[name] = _spectral_chebyshev(cheb_graph(graph), k, seed=0,
                                            mesh=mesh)
        emb = ShardedGraphEmbedder(cheb_graph("regular_1000"), mesh=mesh,
                                   n_components=3, seed=0, verbose=False,
                                   init="chebyshev", sample_size=64)
        res["cheb_embedder"] = emb.positions
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    torch.distributed.destroy_process_group()


def _spawn(tmp_path_factory, world):
    """Per-rank results of a ``world``-rank gloo run of ``worker``."""
    out = tmp_path_factory.mktemp(f"gloo{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(r), str(world),
             str(out / "store"), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return _spawn(tmp_path_factory, WORLD)


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2)


# ---------------------------------------------------------------------- #
# 4 gloo ranks against JAX's 4-device CPU mesh
# ---------------------------------------------------------------------- #

def _jax_variant(graph, kw, world=WORLD):
    pytest.importorskip("jax")
    from graphem_rapids_tpu.parallel import ShardedGraphEmbedder, make_mesh

    adj = GRAPHS[graph]()
    emb = ShardedGraphEmbedder(adj, mesh=make_mesh(world), **PARAMS, **kw)
    emb.positions = start_positions(emb.n)
    for s in samples(emb.n_edges):
        emb.update_positions(sample_indices=s)
    return emb


@pytest.mark.fast
@pytest.mark.parametrize("name", [v for v in VARIANTS if v not in SAME_AS])
def test_gloo_matches_jax_mesh(gloo, name):
    graph, kw = VARIANTS[name]
    ref = _jax_variant(graph, kw)
    port = gloo[0]
    assert bool(port[name + "/fused"]) is bool(ref._fused_refs_active)
    kind = "binned" if "buckets" in ref._nb else "flat"
    assert str(port[name + "/table"]).startswith(kind)
    np.testing.assert_allclose(port[name], ref.positions, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.fast
@pytest.mark.parametrize("name", list(VARIANTS) + list(KNN_CASES)
                         + list(ORDER_KNN_CASES)
                         + list(APPROX_LOCAL_CASES) + list(CHEB_CASES)
                         + ["ckpt/resumed", "run_layout",
                            "run_layout/next_sample", "cheb_embedder"])
def test_gloo_ranks_bit_equal(gloo, name):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(gloo[r][name], gloo[0][name])


@pytest.mark.fast
@pytest.mark.parametrize("name", list(VARIANTS) + ["run_layout"])
def test_gloo_replicas_agree_before_broadcast(gloo, name):
    """On the CPU every rank's own update is rank 0's, bit for bit: the
    broadcast closed no gap."""
    for r in range(WORLD):
        assert float(gloo[r][name + "/gap"]) == 0.0


@pytest.mark.fast
def test_gloo_diverged_ranks_are_caught(gloo):
    """Ranks fed different samples: the gap each closed is far above the
    limit, and the block-end check raises (rank 0 closed none)."""
    from graphem_rapids_torch.parallel.sharded_step import REPLICA_GAP_LIMIT

    assert float(gloo[0]["diverged/gap"]) == 0.0
    assert not bool(gloo[0]["diverged/raised"])
    for r in range(1, WORLD):
        assert float(gloo[r]["diverged/gap"]) > 1e3 * REPLICA_GAP_LIMIT
        assert bool(gloo[r]["diverged/raised"])


@pytest.mark.fast
@pytest.mark.parametrize("name", list(SAME_AS))
def test_gloo_merges_bit_equal_all_gather(gloo, name):
    np.testing.assert_array_equal(gloo[0][name], gloo[0][SAME_AS[name]])


@pytest.mark.fast
@pytest.mark.parametrize("comm", ["all_gather", "all_to_all", "ring"])
def test_gloo_slot_order_knn_sets_equal_row_order(gloo, comm):
    """With fused refs, slot order enumerates the refs in another order;
    the exact merges' neighbour edge sets are the same."""
    np.testing.assert_array_equal(np.sort(gloo[0][f"knn_slot_{comm}"], axis=1),
                                  np.sort(gloo[0][f"knn_row_{comm}"], axis=1))


def _jax_ring_pallas(case, world):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from graphem_rapids_tpu.parallel import build_sharded_step, make_mesh
    from graphem_rapids_tpu.parallel.sharded_step import pad_edges

    graph, fused, order = KNN_CASES[case]
    n, E, edges, nb, pos, sampled = _debug_knn_inputs(graph, order)
    edges_p, valid = pad_edges(edges, world)
    _, _, ops, raw = build_sharded_step(make_mesh(world), n, E, nb=nb,
                                        **_debug_knn_kw(fused))
    knn_idx, samp = raw(jnp.asarray(pos), jnp.asarray(edges_p),
                        jnp.asarray(valid), jnp.asarray(sampled), ops)
    jax.block_until_ready(knn_idx)
    np.testing.assert_array_equal(np.asarray(samp), sampled)
    return np.sort(np.asarray(knn_idx), axis=1)


@pytest.mark.fast
@pytest.mark.parametrize("case", list(APPROX_LOCAL_CASES))
def test_gloo_approx_local_matches_jax(gloo, case):
    """use_approx_local=True on 4 gloo ranks against JAX's 4-device mesh
    with use_approx_local=True: one-shot local distances and an exact
    top-k, as JAX's approx_min_k is off the TPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from graphem_rapids_tpu.parallel import build_sharded_step, make_mesh
    from graphem_rapids_tpu.parallel.sharded_step import pad_edges

    fused, comm = APPROX_LOCAL_CASES[case]
    n, E, edges, nb, pos, _ = _debug_knn_inputs("regular")
    edges_p, valid = pad_edges(edges, WORLD)
    _, _, ops, raw = build_sharded_step(make_mesh(WORLD), n, E, nb=nb,
                                        **_approx_local_kw(fused, comm))
    pos = jnp.asarray(pos)
    for s in samples(E):
        pos = raw(pos, jnp.asarray(edges_p), jnp.asarray(valid),
                  jnp.asarray(s, jnp.int32), ops)
    np.testing.assert_allclose(gloo[0][case], np.asarray(jax.device_get(pos)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.fast
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_gloo_ring_pallas_matches_jax(gloo, case):
    """The bin-fold ring's neighbour sets through the sharded step equal
    JAX's ring_pallas on the same positions and sample."""
    np.testing.assert_array_equal(np.sort(gloo[0][case], axis=1),
                                  _jax_ring_pallas(case, WORLD))


def _assert_match_modulo_signs(X, Y, atol):
    for c in range(Y.shape[1]):
        d = min(np.abs(X[:, c] - Y[:, c]).max(),
                np.abs(X[:, c] + Y[:, c]).max())
        assert d < atol, f"column {c}: {d}"


@pytest.mark.fast
@pytest.mark.parametrize("case", list(CHEB_CASES))
@pytest.mark.parametrize("against", ["single_rank", "jax_mesh"])
def test_gloo_chebyshev_row_sharded(gloo, case, against):
    """The row-sharded Chebyshev init on 4 ranks (one tiled all_gather per
    matvec) against the port's single-rank runner and JAX's 4-device mesh,
    from the same start block: equal modulo column signs at JAX's own
    atol=1e-4 (tests/test_spectral_chebyshev.py), the padded tail and the
    replicated overflow plan included."""
    graph, k = CHEB_CASES[case]
    A = cheb_graph(graph)
    if against == "single_rank":
        from graphem_rapids_torch.ops.laplacian import _spectral_chebyshev

        ref = _spectral_chebyshev(A, k, seed=0)
    else:
        pytest.importorskip("jax")
        from graphem_rapids_tpu.ops.laplacian import _spectral_chebyshev
        from graphem_rapids_tpu.parallel import make_mesh

        ref = _spectral_chebyshev(A, k, seed=0, mesh=make_mesh(WORLD))
    _assert_match_modulo_signs(gloo[0][case], ref, atol=1e-4)


@pytest.mark.fast
def test_gloo_sharded_embedder_chebyshev_init(gloo):
    """ShardedGraphEmbedder(init='chebyshev') on 4 ranks starts from a
    spectral layout aligned with host eigsh (JAX's :198-213 case)."""
    from graphem_rapids_torch.ops.laplacian import (
        _normalized_laplacian,
        _spectral_scipy,
    )

    pos = gloo[0]["cheb_embedder"]
    assert pos.shape == (1000, 3) and np.isfinite(pos).all()
    Xs = _spectral_scipy(_normalized_laplacian(cheb_graph("regular_1000")),
                         3, seed=0)
    Q = np.linalg.qr(pos)[0].T @ np.linalg.qr(Xs)[0]
    assert np.linalg.svd(Q, compute_uv=False).min() > 0.95


@pytest.mark.fast
@pytest.mark.parametrize("check", ["ranks_equal", "ring_pallas", "merges",
                                   "jax", "slot_ring_pallas", "slot_merges",
                                   "slot_jax"])
def test_gloo_two_ranks(gloo2, check):
    """Two ranks: each rank sends right and receives from the left, the
    same peer, in one batch."""
    if check == "ranks_equal":
        for name in list(TWO_RANK_VARIANTS) + list(KNN_CASES):
            np.testing.assert_array_equal(gloo2[1][name], gloo2[0][name])
    elif check == "ring_pallas":
        np.testing.assert_array_equal(np.sort(gloo2[0]["knn_fused"], axis=1),
                                      _jax_ring_pallas("knn_fused", 2))
    elif check == "merges":
        np.testing.assert_array_equal(gloo2[0]["flat_ring"],
                                      gloo2[0]["flat_all_gather"])
        np.testing.assert_array_equal(gloo2[0]["hub_binned_fused_all_to_all"],
                                      gloo2[0]["hub_binned_fused"])
    elif check == "slot_ring_pallas":
        np.testing.assert_array_equal(
            np.sort(gloo2[0]["knn_slot_fused"], axis=1),
            _jax_ring_pallas("knn_slot_fused", 2))
    elif check == "slot_merges":
        np.testing.assert_array_equal(gloo2[0]["flat_slot_ring"],
                                      gloo2[0]["flat_slot"])
        np.testing.assert_array_equal(gloo2[0]["hub_binned_slot_all_to_all"],
                                      gloo2[0]["hub_binned_slot"])
    elif check == "slot_jax":
        for name in ("flat_slot", "hub_binned_slot"):
            ref = _jax_variant(*VARIANTS[name], world=2)
            np.testing.assert_allclose(gloo2[0][name], ref.positions,
                                       rtol=1e-4, atol=1e-5)
    else:
        ref = _jax_variant(*VARIANTS["hub_binned_fused"], world=2)
        np.testing.assert_allclose(gloo2[0]["hub_binned_fused"],
                                   ref.positions, rtol=1e-4, atol=1e-5)


@pytest.mark.fast
def test_gloo_mesh_and_replication(gloo):
    for r in range(WORLD):
        np.testing.assert_array_equal(gloo[r]["mesh"], [r, WORLD, 1])
        np.testing.assert_array_equal(gloo[r]["replicated"], [0, 0, 0])


@pytest.mark.fast
def test_gloo_checkpoint_round_trip(gloo):
    res = gloo[0]
    np.testing.assert_array_equal(res["ckpt/loaded"], res[CKPT_VARIANT])
    assert int(res["ckpt/iteration"]) == STEPS
    np.testing.assert_array_equal(res["ckpt/resumed"], res["ckpt/continued"])


# ---------------------------------------------------------------------- #
# one rank, no process group
# ---------------------------------------------------------------------- #

def test_pad_edges_matches_jax():
    pytest.importorskip("jax")
    from graphem_rapids_tpu.parallel.sharded_step import pad_edges as jpad

    from graphem_rapids_torch.parallel.sharded_step import pad_edges

    rng = np.random.default_rng(0)
    for E, ndev in ((10, 4), (12, 4), (1, 8), (0, 3), (7, 1)):
        edges = rng.integers(0, 50, (E, 2)).astype(np.int32)
        for a, b in zip(pad_edges(edges, ndev), jpad(edges, ndev)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


ONE_RANK = {
    "flat": ("regular", dict()),
    "binned_overflow_plan": ("hub", dict(binned_table=True)),
    "fused_flat": ("regular", dict(fused_midpoints=True)),
    "fused_binned": ("hub", dict(binned_table=True, fused_midpoints=True)),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_mesh_equals_single_card_engine(name):
    """No process group: the sharded step's trajectory is the single-card
    engine's, bit for bit."""
    from graphem_rapids_torch import GraphEmbedderTorch
    from graphem_rapids_torch.parallel import ShardedGraphEmbedder

    graph, kw = ONE_RANK[name]
    adj = GRAPHS[graph]()
    single = GraphEmbedderTorch(adj, device="cpu", **PARAMS, **kw)
    sharded = ShardedGraphEmbedder(adj, device="cpu", **PARAMS, **kw)
    assert sharded.mesh.world_size == 1 and sharded.mesh.group is None
    assert sharded.table_kind == single.table_kind
    assert sharded._fused_refs_active == single._fused_refs_active
    for s in samples(single.n_edges):
        single.update_positions(sample_indices=s)
        sharded.update_positions(sample_indices=s)
    np.testing.assert_array_equal(sharded.positions, single.positions)


@pytest.mark.fast
def test_one_rank_ring_pallas_equals_binfold_engine():
    """One rank: the bin-fold ring over the fused refs has the bins of the
    single-card 'binfold' strategy, so the trajectories are equal."""
    from graphem_rapids_torch import GraphEmbedderTorch
    from graphem_rapids_torch.parallel import ShardedGraphEmbedder

    adj = hub_graph()
    kw = dict(binned_table=True, fused_midpoints=True)
    single = GraphEmbedderTorch(adj, device="cpu", knn_strategy="binfold",
                                **PARAMS, **kw)
    sharded = ShardedGraphEmbedder(adj, device="cpu", knn_comm="ring_pallas",
                                   **PARAMS, **kw)
    for s in samples(single.n_edges):
        single.update_positions(sample_indices=s)
        sharded.update_positions(sample_indices=s)
    np.testing.assert_array_equal(sharded.positions, single.positions)


@pytest.mark.fast
def test_run_layout_and_edge_sharded_spring():
    """run_layout on a one-rank mesh stays finite with unit std; without a
    table the edge-sharded segment sum gives the scatter spring forces."""
    from graphem_rapids_torch.ops.forces import spring_forces
    from graphem_rapids_torch.parallel import ShardedGraphEmbedder, make_mesh
    from graphem_rapids_torch.parallel.sharded_step import (
        build_sharded_step,
        pad_edges,
    )

    adj = regular_graph()
    emb = ShardedGraphEmbedder(adj, device="cpu", **PARAMS)
    pos = emb.run_layout(4, block_size=2)
    assert pos.shape == (300, 3) and np.isfinite(pos).all()
    np.testing.assert_allclose(pos.std(axis=0, ddof=1), 1.0, atol=1e-4)

    edges = _engine_edges(adj)
    start = torch.from_numpy(start_positions(300))
    edges_p, valid = pad_edges(edges, 1)
    _, _, ops, raw = build_sharded_step(
        make_mesh(device="cpu"), 300, len(edges), n_components=3,
        k_attr=0.5, L_min=10.0, k_inter=0.1, n_neighbors=5, sample_size=64,
        _debug_spring=True, return_raw=True)
    got = raw(start, torch.from_numpy(edges_p).long(),
              torch.from_numpy(valid), None, ops)
    f = spring_forces(start, torch.from_numpy(edges).long(), 0.5, 10.0)
    f = f - f.mean(dim=0, keepdim=True)
    want = f / (f.std(dim=0, keepdim=True, unbiased=True) + 1e-6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.fast
def test_step_and_multi_step_draw_from_the_generator():
    """step() samples with the generator it is given; multi_step() is
    that step repeated; raw_step() with the same sample agrees."""
    from graphem_rapids_torch.ops.forces import build_neighbor_table
    from graphem_rapids_torch.ops.sampling import sample_indices
    from graphem_rapids_torch.parallel import make_mesh
    from graphem_rapids_torch.parallel.sharded_step import (
        build_sharded_step,
        pad_edges,
    )

    adj = regular_graph()
    edges = _engine_edges(adj)
    n, E = 300, len(edges)
    edges_p, valid = pad_edges(edges, 1)
    ep, vp = torch.from_numpy(edges_p).long(), torch.from_numpy(valid)
    step, multi, ops, raw = build_sharded_step(
        make_mesh(device="cpu"), n, E, n_components=3, k_attr=0.5,
        L_min=10.0, k_inter=0.1, n_neighbors=5, sample_size=64,
        nb=build_neighbor_table(edges, n), return_raw=True)
    start = torch.from_numpy(start_positions(n))
    pos, gen = start, torch.Generator().manual_seed(4)
    for _ in range(3):
        pos, gen = step(pos, ep, vp, gen, ops)
    multi_pos, _ = multi(start, ep, vp, torch.Generator().manual_seed(4),
                         ops, num_steps=3)
    assert torch.equal(pos, multi_pos)
    sampled = sample_indices(torch.Generator().manual_seed(4), E, 64)
    one, _ = step(start, ep, vp, torch.Generator().manual_seed(4), ops)
    assert torch.equal(one, raw(start, ep, vp, sampled, ops))


@pytest.mark.fast
@pytest.mark.parametrize("entry", ["make_mesh", "default_mesh",
                                   "distributed_init", "create_graphem"])
def test_mesh_needs_a_card_unless_cpu(monkeypatch, entry):
    """Without a card a mesh or a NCCL group raises unless the CPU is asked
    for (device='cpu', backend='gloo'); nothing falls back to the CPU."""
    import graphem_rapids_torch as grt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "make_mesh": grt.make_mesh,
        "default_mesh": grt.default_mesh,
        "distributed_init": lambda: grt.distributed_init(
            init_method="file:///nonexistent/store", world_size=1, rank=0),
        "create_graphem": lambda: grt.create_graphem(
            regular_graph(n=60), backend="sharded", verbose=False),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not torch.distributed.is_initialized()
    assert grt.make_mesh(device="cpu").device.type == "cpu"


@pytest.mark.fast
def test_unported_options_raise():
    from graphem_rapids_torch.parallel import (
        ShardedGraphEmbedder,
        make_mesh,
        mesh_is_multiprocess,
        replicate_to_mesh,
    )
    from graphem_rapids_torch.parallel.sharded_step import build_sharded_step

    from graphem_rapids_torch.ops.forces import build_neighbor_table

    adj = regular_graph(n=60)
    # ref_order='slot' is ported (the gloo cases above hold it against
    # JAX): the engine and the step build
    emb = ShardedGraphEmbedder(adj, device="cpu", ref_order="slot", **PARAMS)
    # the flat slot-major table rides as the one bucket, (cap, n)
    (table_t,) = emb._step_ops["btables"]
    assert emb.ref_order == "slot" and torch.equal(
        table_t, torch.as_tensor(emb._nb["table_t"]).long())
    kw = dict(n_components=3, k_attr=0.5, L_min=10.0, k_inter=0.1,
              n_neighbors=5, sample_size=16)
    mesh = make_mesh(device="cpu")
    # use_approx_local=True is ported (tests/test_torch_approx.py and the
    # gloo cases above hold it against JAX): it builds
    step, multi, ops = build_sharded_step(mesh, 60, 90,
                                          use_approx_local=True, **kw)
    assert callable(step) and callable(multi)
    edges = _engine_edges(adj)
    nb = build_neighbor_table(edges, 60, ref_order="slot")
    step, multi, ops = build_sharded_step(mesh, 60, len(edges), nb=nb, **kw)
    (table_t,) = ops["btables"]
    assert callable(step) and callable(multi) and torch.equal(
        table_t, torch.as_tensor(nb["table_t"]).long())
    with pytest.raises(ValueError, match="knn_comm"):
        build_sharded_step(mesh, 60, 90, knn_comm="nccl", **kw)
    with pytest.raises(ValueError, match="knn_comm"):
        ShardedGraphEmbedder(adj, device="cpu", knn_comm="nccl", **PARAMS)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(4)
    one = make_mesh(device="cpu")
    assert one.shape == {"edges": 1} and not mesh_is_multiprocess(one)
    assert torch.equal(replicate_to_mesh(np.arange(3), one),
                       torch.arange(3))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
