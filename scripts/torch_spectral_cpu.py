#!/usr/bin/env python3
"""The port's spectral init and toolkit against the JAX package, on the CPU.

    python3 scripts/torch_spectral_cpu.py          # about 2 minutes

Prints one JSON line per check, the CPU references that chip_smoke.py's
card phases are read against, at sizes no test runs (the tests hold the
2,000-vertex graphs):

- the SpMV at the full table width of 201 on the star + path graph: the
  JAX plan's form (pads gathered as copies of the row, pad_count times the
  row subtracted) and the port's (pads gather a zero row) against scipy;
- the three 100K graphs of chip_smoke.py's phase 14: both packages against
  eigsh (and the port's span inside eigsh's 8 lowest nontrivial vectors),
  the port against JAX (subspace alignment, the smallest canonical
  correlation, and the largest column gap modulo sign), and the SpMV's
  overflow form;
- the 1M ring + chords graph: the host plan's seconds and shape, and the
  whole Chebyshev init on the CPU with its Ritz values;
- run_benchmark on the BA graph of phase 15 and the karate graph, with
  Spearman(radius, degree).

Needs JAX (the reference) and networkx; runs from the repository root.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as cs  # noqa: E402
import graphem_rapids_torch as grt  # noqa: E402
from graphem_rapids_torch.ops import laplacian as lap  # noqa: E402
from graphem_rapids_tpu.ops import laplacian as jlap  # noqa: E402


def emit(check, **fields):
    print(json.dumps({"check": check, **fields}), flush=True)


def full_width_spmv():
    import networkx as nx

    G = nx.star_graph(200)
    G.add_edges_from((i, i + 1) for i in range(1, 150))
    A = sp.csr_matrix(nx.adjacency_matrix(G, dtype=int))
    X = np.random.default_rng(0).standard_normal((A.shape[0], 4)).astype(
        np.float32)
    want = A @ X
    jplan = jlap._adjacency_matvec_plan(A, cap=201)
    Xt = torch.from_numpy(X)
    jax_form = (Xt[np.asarray(jplan["table"])].sum(dim=1)
                - torch.from_numpy(np.asarray(jplan["pad_count"]))[:, None]
                * Xt).numpy()
    plan = lap._adjacency_matvec_plan(A, cap=201)
    Y_ext = torch.cat([Xt, torch.zeros(1, 4)])
    port = Y_ext[plan["table"]].sum(dim=1).numpy()
    for name, got in (("pad_count_subtracted", jax_form),
                      ("zero_row", port)):
        err = np.abs(got - want)
        emit("spmv_width_201", form=name, max_abs_err=float(err.max()),
             worst_over_test_tolerance=float(
                 (err - (1e-4 + 1e-3 * np.abs(want))).max()))


def graphs_100k():
    log = cs.spectral_log()
    for name, adj in (("ring_chords_100k", cs.ring_chords_graph(100_000,
                                                                300_000)),
                      ("hub_chords_100k", cs.hub_chords_graph()),
                      ("random_8_regular_100k",
                       cs.regular_union_graph(100_000))):
        L = lap._normalized_laplacian(adj)
        lam, V = spla.eigsh(L, 9, which="SM",
                            v0=np.random.default_rng(0).standard_normal(
                                adj.shape[0]))
        port = lap._spectral_chebyshev(adj, 3, seed=0)
        overflow = cs.chebyshev_fields(log, name, 1)["spmv_overflow"]
        ref = jlap._spectral_chebyshev(adj, 3, seed=0)
        emit("chebyshev_100k", graph=name, spmv_overflow=overflow,
             eigsh_eigenvalues=lam.tolist(),
             align_port_jax=cs.alignment(port, ref),
             max_gap_port_jax_modulo_sign=cs.max_err_modulo_signs(port, ref),
             align_port_eigsh=cs.alignment(port, V[:, 1:4]),
             align_jax_eigsh=cs.alignment(ref, V[:, 1:4]),
             align_port_in_eigsh_8=cs.alignment(port, V[:, 1:9]))


def graph_1m():
    adj = cs.ring_chords_graph()
    t0 = time.perf_counter()
    A = sp.csr_matrix(adj + adj.transpose())
    A.data = np.ones_like(A.data)
    A.setdiag(0)
    A.eliminate_zeros()
    t1 = time.perf_counter()
    plan = lap._adjacency_matvec_plan(A)
    t2 = time.perf_counter()
    ov = plan["ov_plan"]
    log = cs.spectral_log()
    lap._spectral_chebyshev(adj, 3, seed=0)
    emit("chebyshev_1m", symmetrize_s=t1 - t0, plan_s=t2 - t1,
         cap=int(plan["table"].shape[1]),
         block_pairs=0 if ov is None else int(len(ov["nbr"])),
         **cs.chebyshev_fields(log, "ring_chords_1m", 1))


def toolkit():
    from scipy.stats import spearmanr

    params = cs.TOOLKIT_PARAMS
    res = grt.run_benchmark(grt.generate_ba, params, compute_centrality=False,
                            device="cpu", seed=0)
    deg = grt.compute_vertex_degrees(grt.generate_ba(**params))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["GRAPHEM_DATA_DIR"] = tmp
        adj = grt.load_dataset_as_adjacency("local-karate")
    pos = grt.create_graphem(adj, n_components=2, seed=0, verbose=False,
                             device="cpu").run_layout(30)
    emit("toolkit_cpu",
         spearman_ba=float(spearmanr(res["radii"], deg).statistic),
         spearman_karate=float(spearmanr(
             np.linalg.norm(pos, axis=1),
             grt.compute_vertex_degrees(adj)).statistic))


if __name__ == "__main__":
    full_width_spmv()
    graphs_100k()
    graph_1m()
    toolkit()
