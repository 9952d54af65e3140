"""ref_order='slot' in the port against the JAX package, on the CPU.

The slot-major builders must give host arrays equal to the JAX builders'
(``to_device=False``): the transposed tables and the flat and binned ref
maps (``ref_edge``, ``ref_valid``, ``edge_ref``), with and without a ref
budget that trims columns. The slotwise step ops must agree with JAX's on
the same positions: refs bit for bit (the same (a + b) * 0.5 per slot) and
forces at rtol=1e-6 (the same per-slot terms, summed slot by slot). The
port's slot trajectory must equal its own row trajectory, as
tests/test_slot_order.py::test_slot_vs_row_trajectory holds JAX's: the kNN
sees the refs in another order but maps them back to the same edges.
"""

import numpy as np
import pytest
import torch

import graphem_rapids_tpu as gr
from graphem_rapids_tpu.ops import forces as jf
from graphem_rapids_torch import GraphEmbedderTorch
from graphem_rapids_torch.ops import forces as tf

PARAMS = dict(k_attr=0.5, L_min=10.0, k_inter=0.1)


def _edges(adj):
    rows, cols = adj.nonzero()
    mask = rows < cols
    return np.column_stack([rows[mask], cols[mask]]).astype(np.int32)


def _hub_edges(n=400, seed=2):
    """Two hubs and random edges: an overflow plan on the binned tables."""
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 300)] + [(1, j) for j in range(2, 200)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (700, 2)) if a != b]
    return np.unique(np.array(sorted(set(e)), np.int32), axis=0), n


GRAPHS = {
    "regular": lambda: (_edges(gr.generate_random_regular(n=120, d=6,
                                                          seed=0)), 120),
    "ba": lambda: (_edges(gr.generate_ba(n=300, m=3, seed=4)), 300),
    "hub": _hub_edges,
}


def _same(port, ref, path="nb"):
    """Every key of the port's dict equals the JAX dict's value."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for key, val in port.items():
            _same(val, ref[key], f"{path}[{key!r}]")
    elif isinstance(port, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}[{i}]")
    elif port is None:
        assert ref is None, path
    else:
        a, b = np.asarray(port), np.asarray(ref)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("budget", [None, 0.8])
def test_flat_slot_maps_equal_jax(name, budget):
    edges, n = GRAPHS[name]()
    ref_budget = None
    if budget is not None:
        full = tf.build_neighbor_table(edges, n, ref_order="slot")
        ref_budget = int(len(full["ref_edge"]) * budget)
    port = tf.build_neighbor_table(edges, n, ref_order="slot",
                                   ref_budget=ref_budget)
    ref = jf.build_neighbor_table(edges, n, ref_order="slot",
                                  ref_budget=ref_budget, to_device=False)
    assert port["ref_order"] == "slot" and port["table_t"].shape[1] == n
    _same(port, ref)
    # slot (v, s) sits at s*n + v; the row tables hold the same slots
    row = tf.build_neighbor_table(edges, n, ref_budget=ref_budget)
    np.testing.assert_array_equal(port["table_t"], row["table"].T)
    rc = row["ref_cap"]
    in_table = row["edge_ref"] < n * rc
    v, s = np.divmod(row["edge_ref"][in_table], rc)
    np.testing.assert_array_equal(port["edge_ref"][in_table], s * n + v)


@pytest.mark.fast
@pytest.mark.parametrize("name", ["ba", "hub"])
@pytest.mark.parametrize("budget", [None, 0.9])
def test_binned_slot_maps_equal_jax(name, budget):
    edges, n = GRAPHS[name]()
    ref_budget = None
    if budget is not None:
        full = tf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                              ref_order="slot")
        ref_budget = int(len(full["ref_edge"]) * budget)
    port = tf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                          ref_order="slot",
                                          ref_budget=ref_budget)
    ref = jf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                         ref_order="slot",
                                         ref_budget=ref_budget,
                                         to_device=False)
    assert port is not None and len(port["buckets"]) > 1
    for g in port["buckets"]:
        assert g["table_t"].shape == (g["cap"], g["count"])
    _same(port, ref)


def _slotwise_inputs(name, binned, seed=0):
    edges, n = GRAPHS[name]()
    if binned:
        nb = tf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                            ref_order="slot")
        jnb = jf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                             ref_order="slot")
    else:
        nb = tf.build_neighbor_table(edges, n, ref_order="slot")
        jnb = jf.build_neighbor_table(edges, n, ref_order="slot")
    pos = np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)
    return nb, jnb, pos


def _overflow_args(nb, use_plan, put):
    plan = nb["overflow_plan"]
    if use_plan and plan is not None:
        return None, {"pairs": put(plan["pairs"]),
                      "block_hub": put(plan["block_hub"]),
                      "hub_ids": put(plan["hub_ids"]),
                      "block": plan["block"]}
    ov = nb["overflow"]
    return (put(ov) if len(ov) else None), None


@pytest.mark.fast
@pytest.mark.parametrize("case", ["flat_regular", "flat_hub_plan",
                                  "flat_hub_scatter", "binned_ba",
                                  "binned_hub_plan", "binned_hub_scatter"])
def test_slotwise_ops_match_jax(case):
    import jax
    import jax.numpy as jnp

    binned = case.startswith("binned")
    name = case.split("_")[1]
    use_plan = not case.endswith("scatter")
    nb, jnb, pos = _slotwise_inputs(name, binned)
    pt, jp = torch.from_numpy(pos), jnp.asarray(pos)
    t_put = lambda a: torch.as_tensor(np.asarray(a)).long()  # noqa: E731
    t_ov, t_plan = _overflow_args(nb, use_plan, t_put)
    j_ov, j_plan = _overflow_args(nb, use_plan, jnp.asarray)
    olt = nb["overflow_lt"]
    t_olt = t_put(olt) if len(olt) else None
    j_olt = jnp.asarray(olt) if len(olt) else None
    rv = torch.as_tensor(nb["ref_valid"])
    # JAX's op under jit, as its engine runs it (and far faster than
    # op by op); the plan's block size stays static
    block = None if j_plan is None else j_plan.pop("block")

    def j_op(p, tables, ref_valid, olt, ov, plan):
        plan = None if plan is None else {**plan, "block": block}
        if binned:
            return jf.spring_refs_binned_slotwise(
                p, tables, jnb, PARAMS["k_attr"], PARAMS["L_min"],
                ref_valid=ref_valid, overflow_lt=olt, overflow_edges=ov,
                overflow_plan=plan)
        return jf.spring_refs_slotwise(
            p, tables, jnb, PARAMS["k_attr"], PARAMS["L_min"],
            ref_valid=ref_valid, overflow_lt=olt, overflow_edges=ov,
            overflow_plan=plan)

    j_tables = ([g["table_t"] for g in jnb["buckets"]] if binned
                else jnb["table_t"])
    j_f, j_r = jax.jit(j_op)(jp, j_tables, jnb["ref_valid"], j_olt, j_ov,
                             j_plan)
    # a flat table is the one bucket
    buckets = tf.table_buckets(nb)
    t_tables = [t_put(g["table_t"]) for g in buckets]
    t_f, t_r = tf.spring_refs_binned_slotwise(
        pt, t_tables, buckets, PARAMS["k_attr"], PARAMS["L_min"],
        ref_valid=rv, overflow_lt=t_olt, overflow_edges=t_ov,
        overflow_plan=t_plan)
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), rtol=1e-6,
                               atol=1e-6)
    # every edge's ref holds its midpoint (engine numbering)
    ei = nb["edges_int"] if binned else GRAPHS[name]()[0]
    mid = (pos[ei[:, 0]] + pos[ei[:, 1]]) * np.float32(0.5)
    np.testing.assert_array_equal(t_r.numpy()[nb["edge_ref"]], mid)
    # without refs: the same forces, no refs
    kw = dict(ref_valid=rv, overflow_lt=t_olt, overflow_edges=t_ov,
              overflow_plan=t_plan, want_refs=False)
    f2, r2 = tf.spring_refs_binned_slotwise(
        pt, t_tables, buckets, PARAMS["k_attr"], PARAMS["L_min"], **kw)
    assert r2 is None and torch.equal(f2, t_f)


@pytest.mark.fast
@pytest.mark.parametrize("case", ["binned_fused", "flat_fused", "auto"])
def test_slot_vs_row_trajectory(case):
    """The port's slot order reproduces its row trajectory (JAX's test)."""
    kw = {
        "binned_fused": dict(binned_table=True, fused_midpoints=True),
        "flat_fused": dict(binned_table=False, fused_midpoints=True),
        "auto": {},
    }[case]
    adj = gr.erdos_renyi_graph(n=400, p=0.03, seed=1)
    got = {}
    for order in ("row", "slot"):
        emb = GraphEmbedderTorch(adj, device="cpu", n_components=3, seed=7,
                                 verbose=False, ref_order=order,
                                 sample_size=64, n_neighbors=8, **kw)
        assert emb._nb["ref_order"] == order
        for t in range(6):
            sampled = np.sort(np.random.default_rng(100 + t).choice(
                emb.n_edges, 64, replace=False))
            emb.update_positions(sample_indices=sampled)
        got[order] = emb.positions
    np.testing.assert_allclose(got["slot"], got["row"], rtol=1e-3,
                               atol=1e-4)
