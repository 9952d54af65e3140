"""The plain reference against the port's CPU path on small graphs.

The reference (``portbench/reference/``) imports nothing of the port;
these tests import both and hold them together: the ref space the
reference works out against the port's tables, one layout step against
the port's step through its bin-fold kNN, the starts, and the spread
estimate, which must be equal.
"""

import numpy as np
import pytest
import torch

from conftest import make_graph

from portbench.reference import influence, layout, tables

ENGINE = {"n_components": 3, "L_min": 10.0, "k_attr": 0.5, "k_inter": 0.1,
          "n_neighbors": 15, "sample_size": 512}


def graph(family, n, chords, seed=1):
    spec = {"family": family, "vertices": n, "chords": chords,
            "zipf_a": 1.6}
    return make_graph(spec, seed, "cpu")[0]


@pytest.mark.parametrize("family,n,chords,binned", [
    ("skewed", 3000, 9000, True), ("skewed", 30_000, 90_000, True),
    ("ring", 3000, 7500, True), ("ring", 3000, 0, False)])
def test_ref_space_is_the_ports(family, n, chords, binned):
    from graphem_rapids_torch.models.embedder import csr_upper_edges
    from graphem_rapids_torch.ops import forces

    adj = graph(family, n, chords)
    space = tables.ref_space(adj.indptr, adj.indices, "cpu")
    edges = csr_upper_edges(adj)
    nb = forces.build_neighbor_table_binned(edges, n)
    assert (nb is not None) == binned
    if nb is None:
        nb = forces.build_neighbor_table(edges, n)
        perm = np.arange(n)
        edge_user = np.arange(len(edges))
    else:
        perm, edge_user = nb["perm"], nb["edge_user"]
    n_slots = len(nb["ref_valid"])
    valid = np.concatenate([nb["ref_valid"],
                            np.ones(len(nb["ref_edge"]) - n_slots, bool)])
    ref_edge = np.where(valid, nb["ref_edge"], -1)
    assert np.array_equal(space.ref_edge.numpy(), ref_edge)
    assert np.array_equal(space.edge_ref.numpy(), nb["edge_ref"])
    assert np.array_equal(space.perm.numpy(), perm)
    assert np.array_equal(space.edge_user.numpy(), edge_user)


def test_ref_budget_drops_columns_as_the_port_does():
    from graphem_rapids_torch.models.embedder import csr_upper_edges
    from graphem_rapids_torch.ops import forces

    adj = graph("skewed", 30_000, 90_000)
    edges = csr_upper_edges(adj)
    budget = 40_000
    nb = forces.build_neighbor_table_binned(edges, 30_000,
                                            ref_budget=budget)
    space = tables.ref_space(adj.indptr, adj.indices, "cpu", budget)
    assert len(space.ref_edge) == len(nb["ref_edge"])
    assert np.array_equal(space.edge_ref.numpy(), nb["edge_ref"])


@pytest.mark.parametrize("n_edges", [12_000, 300_000])
def test_sample_draws_are_the_ports(n_edges):
    """The frozen sample rule gives the port's draws, one after another,
    below and above the uniforms' cut; a draw repeated, or taken from
    another seed, does not match."""
    from graphem_rapids_torch.ops.sampling import sample_indices

    gen = torch.Generator().manual_seed(2**31 + 5)
    got = [sample_indices(gen, n_edges, 512) for _ in range(4)]
    draws = layout.SampleDraws(2**31 + 5, n_edges, 512, "cpu")
    assert draws.matches(0, got[0]) and draws.matches(2, got[2])
    assert draws.matches(3, got[3])
    assert not layout.SampleDraws(2**31 + 5, n_edges, 512, "cpu").matches(
        1, got[0])
    assert not layout.SampleDraws(2**31 + 6, n_edges, 512, "cpu").matches(
        0, got[0])
    with pytest.raises(ValueError):
        draws.matches(1, got[1])


@pytest.mark.parametrize("family,init", [("skewed", "chebyshev"),
                                         ("ring", "random")])
def test_step_and_start_follow_the_port(family, init):
    import graphem_rapids_torch as grt

    adj = graph(family, 3000, 9000)
    emb = grt.create_graphem(adj, backend="binfold", device="cpu", seed=7,
                             init=init, verbose=False, **ENGINE)
    start = emb.positions
    drawn = {}
    original = emb._sample

    def recorded():
        drawn["s"] = original()
        return drawn["s"]

    emb._sample = recorded
    before = emb.run_layout(3)
    after = emb.run_layout(1)
    sample = drawn["s"]
    assert layout.check_sample(sample.numpy(), emb.n_edges, 512)
    draws = layout.SampleDraws(7, emb.n_edges, 512, "cpu")
    assert draws.matches(3, sample)
    space = tables.ref_space(adj.indptr, adj.indices, "cpu")
    e0, e1 = tables.upper_edges(adj.indptr, adj.indices, "cpu")
    ref = layout.LayoutReference(space, e0, e1, ENGINE)
    R, scale = ref.step(torch.as_tensor(before), sample)
    gap = float(layout.step_gaps(torch.as_tensor(after), R, scale).max())
    assert gap < 1e-4
    C, _ = ref.step(torch.as_tensor(before), sample, dtype=torch.bfloat16)
    assert float(layout.step_gaps(C, R, scale).max()) > 1e-3
    if init == "random":
        assert np.array_equal(start, layout.random_start(3000, 3, 7))
    else:
        X, ritz = layout.chebyshev_start(adj.indptr, adj.indices, 3, 7,
                                         "cpu")
        assert torch.all(ritz[1:] >= ritz[:-1])
        assert layout.subspace_gap(torch.as_tensor(start), X[:, :3]) < 1e-4
        assert layout.subspace_gap(torch.as_tensor(start), X[:, :4]) < 1e-4
        Xc, _ = layout.chebyshev_start(adj.indptr, adj.indices, 3, 7, "cpu",
                                       dtype=torch.bfloat16)
        assert layout.subspace_gap(Xc[:, :3], X[:, :4]) > 1e-3


def test_knn_rule_is_the_ports_plain_fold():
    """The frozen selection against the port's bin fold on the CPU,
    segments included (with its segment bound lowered)."""
    from graphem_rapids_torch.ops import knn_binfold as bf

    from portbench.reference import binfold

    g = torch.Generator().manual_seed(3)
    refs = torch.rand((20_000, 3), generator=g)
    queries = refs[:64] + 1e-4
    pad = torch.zeros(20_000, dtype=torch.bool)
    for max_refs in (1 << 24, 6000):
        saved = bf.MAX_REFS, binfold.MAX_REFS
        bf.MAX_REFS = binfold.MAX_REFS = max_refs
        try:
            want, _ = bf.knn_binfold(queries, refs, 16)
            got, _, _ = binfold.knn_binfold(queries, refs, pad, 16,
                                         dtype=torch.float32)
        finally:
            bf.MAX_REFS, binfold.MAX_REFS = saved
        assert torch.equal(got, want.long())


@pytest.mark.parametrize("family", ["skewed", "ring"])
def test_spread_estimate_equals_the_ports(family, monkeypatch):
    import graphem_rapids_torch as grt

    adj = graph(family, 3000, 9000)
    cg = influence.CascadeGraph(adj.indptr, adj.indices, "cpu")
    rng = np.random.default_rng(4)
    for _ in range(2):
        seeds = rng.choice(3000, 10, replace=False)
        key = int(rng.integers(0, 2**62))
        want = grt.estimated_influence(adj, seeds, p=0.1, num_sims=64,
                                       key=key, device="cpu")
        got, counts, steps = cg.estimate(seeds, 0.1, 64, 200, key)
        assert got == want and steps >= 2
        thr = influence.threshold(float(torch.tensor(0.1).bfloat16()))
        assert cg.estimate(seeds, 0.1, 64, 200, key, thr=thr)[0] != want


def test_spread_scatter_form_equals_the_ports(monkeypatch):
    import graphem_rapids_torch as grt
    from graphem_rapids_torch.ops import ic_sim

    adj = graph("skewed", 2000, 6000)
    monkeypatch.setattr(ic_sim, "TABLE_BUDGET_SLOTS", 0)
    monkeypatch.setattr(influence, "TABLE_BUDGET_SLOTS", 0)
    cg = influence.CascadeGraph(adj.indptr, adj.indices, "cpu")
    assert cg.form == "scatter"
    seeds = np.arange(0, 2000, 200)
    want = grt.estimated_influence(adj, seeds, p=0.1, num_sims=64, key=9,
                                   device="cpu")
    assert cg.estimate(seeds, 0.1, 64, 200, 9)[0] == want
