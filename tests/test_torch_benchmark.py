"""The port's benchmark API against the JAX package's (the benchmark cases
of tests/test_integration.py), on the CPU.

The layouts of the two packages draw from different random streams, so the
gate is the benchmark's own measure: on the same BA graph the radius-degree
Spearman rho of both is at least 0.5 and within 0.1 of each other. The
centralities are networkx's, equal in both; ``compute_centrality=False``
runs without networkx.
"""

import sys

import numpy as np
import pytest
from scipy.stats import spearmanr

import graphem_rapids_tpu as gr
import graphem_rapids_torch as grt
from graphem_rapids_tpu import benchmark as jbench
from graphem_rapids_torch import benchmark as bench

MEASURES = {"degree", "betweenness", "eigenvector", "pagerank", "closeness",
            "node_load"}


@pytest.mark.fast
def test_benchmark_api_smoke():
    res = grt.benchmark_correlations(
        grt.erdos_renyi_graph, {"n": 60, "p": 0.1, "seed": 0},
        dim=2, num_iterations=5, sample_size=64, device="cpu",
    )
    assert set(res["correlations"]) == MEASURES
    assert res["layout_time"] > 0
    assert res["edges_per_second"] > 0
    assert res["positions"].shape == (60, 2)
    np.testing.assert_allclose(res["radii"],
                               np.linalg.norm(res["positions"], axis=1))


@pytest.mark.fast
def test_centralities_equal_jax():
    adj = grt.erdos_renyi_graph(80, 0.08, seed=2)
    got = bench.compute_centralities(bench._adjacency_to_nx(adj))
    want = jbench.compute_centralities(jbench._adjacency_to_nx(adj))
    assert set(got) == MEASURES
    for key in MEASURES:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)


@pytest.mark.fast
def test_radius_degree_spearman_matches_jax():
    adj = grt.generate_ba(n=300, m=3, seed=0)

    def ba_graph():
        return adj

    deg = grt.compute_vertex_degrees(adj)
    port = grt.run_benchmark(ba_graph, {}, compute_centrality=False,
                             device="cpu", seed=0)
    ref = gr.run_benchmark(ba_graph, {}, compute_centrality=False, seed=0)
    rho = spearmanr(port["radii"], deg).statistic
    rho_ref = spearmanr(ref["radii"], deg).statistic
    assert port["graph_type"] == "ba_graph" and port["m"] == ref["m"]
    assert rho >= 0.5 and rho_ref >= 0.5
    assert abs(rho - rho_ref) < 0.1, (rho, rho_ref)


@pytest.mark.fast
def test_run_benchmark_without_networkx(monkeypatch):
    monkeypatch.setitem(sys.modules, "networkx", None)
    res = grt.run_benchmark(grt.generate_ws, {"n": 80, "k": 4, "seed": 0},
                            num_iterations=3, sample_size=32,
                            compute_centrality=False, device="cpu", seed=0)
    assert np.isfinite(res["positions"]).all()
    assert not MEASURES & set(res)
    with pytest.raises(ImportError):
        grt.run_benchmark(grt.generate_ws, {"n": 80, "k": 4, "seed": 0},
                          num_iterations=1, device="cpu")


@pytest.mark.fast
def test_influence_benchmark_smoke():
    res = grt.run_influence_benchmark(
        grt.erdos_renyi_graph, {"n": 40, "p": 0.15, "seed": 0},
        k=3, p=0.2, iterations=20, num_layout_iterations=3,
        num_random_baselines=2, num_sims=8, device="cpu",
    )
    for key in ("graphem_influence", "greedy_influence", "random_influence",
                "graphem_efficiency", "greedy_efficiency"):
        assert key in res
    assert len(res["graphem_seeds"]) == 3
    assert len(res["greedy_seeds"]) == 3
    # a seed set's spread counts its own seeds
    assert res["graphem_influence"] >= 3 and res["greedy_influence"] >= 3
