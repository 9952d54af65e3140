"""Step ops of the PyTorch port against the JAX ops and the numpy oracle.

Each op gets the same inputs, made with numpy from a seed, in both
packages. Forces are held at rtol=1e-5, atol=1e-5 against the JAX op and
against the port's models/oracle.py in float64: the tolerance covers the
summation order, which differs between index_add_, segment_sum and
np.add.at. Midpoint refs and the intersection test are held bit for bit,
and the port's oracle is bit-equal to the JAX package's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphem_rapids_tpu.ops as jops
import graphem_rapids_torch.ops as tops
from graphem_rapids_tpu.models import oracle as joracle
from graphem_rapids_tpu.ops import forces as jf
from graphem_rapids_tpu.ops.intersect import segments_intersect_2d as j_sid
from graphem_rapids_torch.models import oracle
from graphem_rapids_torch.ops import forces as tf
from graphem_rapids_torch.ops import sampling
from graphem_rapids_torch.ops.intersect import segments_intersect_2d as t_sid

# both packages' ops re-export the knn() function under the module name
tknn = importlib.import_module("graphem_rapids_torch.ops.knn")
jknn = importlib.import_module("graphem_rapids_tpu.ops.knn")

K_ATTR, L_MIN, K_INTER = 0.5, 10.0, 0.1
TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(n=200, m=900, seed=0, hubs=True):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (m, 2))
    if hubs:  # two hubs, so the tables overflow at small caps
        e = np.concatenate([e, np.column_stack([np.zeros(150, int),
                                                rng.integers(1, n, 150)]),
                            np.column_stack([np.ones(90, int),
                                             rng.integers(2, n, 90)])])
    e = e[e[:, 0] != e[:, 1]]
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 3
    return e, n, pos


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _plan_t(plan):
    if plan is None:
        return None
    return {k: (v if k == "block" else _t(v).long()) for k, v in plan.items()}


def _plan_j(plan):
    if plan is None:
        return None
    return {k: (v if k == "block" else jnp.asarray(v)) for k, v in plan.items()}


@pytest.mark.fast
def test_spring_scatter_form():
    e, n, pos = _graph()
    got = tf.spring_forces(_t(pos), _t(e), K_ATTR, L_MIN).numpy()
    ref = np.asarray(jf.spring_forces(jnp.asarray(pos), jnp.asarray(e),
                                      K_ATTR, L_MIN))
    orc = oracle.spring_forces_np(pos.astype(np.float64), e, K_ATTR, L_MIN)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, orc, **TOL)


@pytest.mark.fast
@pytest.mark.parametrize("use_plan", [False, True])
def test_spring_scatter_plan(use_plan):
    """spring_forces with and without build_scatter_plan against the JAX
    op (rtol=1e-5, as tests/test_oracle_parity.py holds JAX's plan)."""
    e, n, pos = _graph(seed=5)
    plan = tf.build_scatter_plan(e, n, device="cpu") if use_plan else None
    got = tf.spring_forces(_t(pos), _t(e), K_ATTR, L_MIN,
                           scatter_plan=plan).numpy()
    jplan = jf.build_scatter_plan(e, n) if use_plan else None
    ref = np.asarray(jf.spring_forces(jnp.asarray(pos), jnp.asarray(e),
                                      K_ATTR, L_MIN, jplan))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if use_plan:
        np.testing.assert_array_equal(plan["perm"].numpy(), jplan["perm"])
        np.testing.assert_array_equal(plan["sorted_ids"].numpy(),
                                      jplan["sorted_ids"])
        assert plan["n"] == jplan["n"] == n


@pytest.mark.fast
def test_scatter_plan_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e, n, _ = _graph()
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.build_scatter_plan(e, n)


@pytest.mark.fast
def test_ops_exports_match_jax():
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


@pytest.mark.fast
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_bit_equal_to_jax_oracle(seed):
    rng = np.random.default_rng(seed)
    n, m = 60, 200
    e = rng.integers(0, n, (m, 2))
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    pos = rng.standard_normal((n, 3))
    sampled = rng.choice(len(e), 16, replace=False)
    kw = dict(k_attr=K_ATTR, L_min=L_MIN, k_inter=K_INTER, n_neighbors=5)
    np.testing.assert_array_equal(
        oracle.update_step_np(pos, e, sampled, **kw),
        joracle.update_step_np(pos, e, sampled, **kw))
    np.testing.assert_array_equal(
        oracle.spring_forces_np(pos, e, K_ATTR, L_MIN),
        joracle.spring_forces_np(pos, e, K_ATTR, L_MIN))
    mid = (pos[e[:, 0]] + pos[e[:, 1]]) / 2
    knn_idx = oracle.knn_np(mid[sampled], mid, 6)
    np.testing.assert_array_equal(knn_idx, joracle.knn_np(mid[sampled], mid, 6))
    np.testing.assert_array_equal(
        oracle.intersection_forces_np(pos, e, knn_idx[:, 1:], sampled,
                                      K_INTER),
        joracle.intersection_forces_np(pos, e, knn_idx[:, 1:], sampled,
                                       K_INTER))


@pytest.mark.fast
@pytest.mark.parametrize("cap,use_plan", [(None, True), (6, True), (6, False)])
def test_spring_flat_table(cap, use_plan):
    e, n, pos = _graph()
    nb = tf.build_neighbor_table(e, n, cap=cap)
    plan = nb["overflow_plan"] if use_plan else None
    ov = nb["overflow"] if (not use_plan or plan is None) else None
    if cap is not None:
        assert len(nb["overflow"]) > 0
    pt = _t(pos)
    buckets = tf.table_buckets(nb)  # the flat table's one bucket
    got = tf.spring_forces_binned(
        pt, [pt[_t(g["table"]).long()] for g in buckets], buckets, K_ATTR,
        L_MIN, None if ov is None else _t(ov).long(), _plan_t(plan),
    ).numpy()
    pj = jnp.asarray(pos)
    ref = np.asarray(jf.spring_forces_from_gathered(
        pj, pj[jnp.asarray(nb["table"])], {"n": n}, K_ATTR, L_MIN,
        None if ov is None else jnp.asarray(ov), _plan_j(plan),
    ))
    orc = oracle.spring_forces_np(pos.astype(np.float64), e, K_ATTR, L_MIN)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, orc, **TOL)


@pytest.mark.fast
def test_spring_binned_tables():
    e, n, pos = _graph(seed=3)
    nbb = tf.build_neighbor_table_binned(e, n, overhead_rows=0)
    assert nbb is not None and nbb["overflow_plan"] is not None
    pos_int = pos[nbb["perm"]]
    pt = _t(pos_int)
    pn_t = [pt[_t(g["table"]).long()] for g in nbb["buckets"]]
    got = tf.spring_forces_binned(pt, pn_t, nbb["buckets"], K_ATTR, L_MIN,
                                  None, _plan_t(nbb["overflow_plan"]))
    pj = jnp.asarray(pos_int)
    pn_j = [pj[jnp.asarray(g["table"])] for g in nbb["buckets"]]
    ref = jf.spring_forces_binned(pj, pn_j, nbb, K_ATTR, L_MIN, None,
                                  _plan_j(nbb["overflow_plan"]))
    orc = oracle.spring_forces_np(pos_int.astype(np.float64),
                                  nbb["edges_int"], K_ATTR, L_MIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), orc, **TOL)


@pytest.mark.fast
@pytest.mark.parametrize("binned", [False, True])
def test_midpoint_refs_bitwise(binned):
    e, n, pos = _graph(seed=5)
    if binned:
        nb = tf.build_neighbor_table_binned(e, n, overhead_rows=0)
        pos = pos[nb["perm"]]
    else:
        nb = tf.build_neighbor_table(e, n, cap=6)
    pt, pj = _t(pos), jnp.asarray(pos)
    ov_t = _t(nb["overflow_lt"]).long()
    ov_j = jnp.asarray(nb["overflow_lt"])
    assert len(nb["overflow_lt"]) > 0
    if binned:
        pn_t = [pt[_t(g["table"]).long()] for g in nb["buckets"]]
        pn_j = [pj[jnp.asarray(g["table"])] for g in nb["buckets"]]
        got = tf.midpoint_refs_binned(pt, pn_t, nb["buckets"],
                                      _t(nb["ref_valid"]), ov_t)
        ref = jf.midpoint_refs_binned(
            pj, pn_j, {**nb, "ref_valid": jnp.asarray(nb["ref_valid"])}, ov_j)
    else:
        buckets = tf.table_buckets(nb)  # the flat table's one bucket
        got = tf.midpoint_refs_binned(
            pt, [pt[_t(g["table"]).long()] for g in buckets], buckets,
            _t(nb["ref_valid"]), ov_t)
        ref = jf.midpoint_refs_from_gathered(
            pj, pj[jnp.asarray(nb["table"])],
            {**nb, "ref_valid": jnp.asarray(nb["ref_valid"])}, ov_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # every edge's ref slot holds its direct midpoint, bit for bit
    edges = nb["edges_int"] if binned else e
    direct = (pos[edges[:, 0]] + pos[edges[:, 1]]) / np.float32(2.0)
    np.testing.assert_array_equal(got.numpy()[nb["edge_ref"]], direct)
    assert tf.REF_PAD_VALUE == jf.REF_PAD_VALUE


def _intersection_inputs(seed=7, S=40, k=6):
    e, n, pos = _graph(n=120, m=500, seed=seed, hubs=False)
    pos = pos[:, :2].copy()  # 2D so that many candidate pairs intersect
    rng = np.random.default_rng(seed)
    sampled = rng.permutation(len(e))[:S]
    mid = (pos[e[:, 0]] + pos[e[:, 1]]) / 2.0
    knn_idx = oracle.knn_np(mid[sampled], mid, k + 1)[:, 1:]
    return e, pos, sampled, knn_idx


@pytest.mark.fast
def test_intersection_forces():
    e, pos, sampled, knn_idx = _intersection_inputs()
    got = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                 K_INTER).numpy()
    ref = np.asarray(jf.intersection_forces(
        jnp.asarray(pos), jnp.asarray(e), jnp.asarray(knn_idx),
        jnp.asarray(sampled), K_INTER))
    orc = oracle.intersection_forces_np(pos.astype(np.float64), e, knn_idx,
                                        sampled, K_INTER)
    assert np.abs(orc).max() > 0  # some pairs do intersect
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, orc, **TOL)


@pytest.mark.fast
def test_intersection_forces_edge_order():
    e, pos, sampled, knn_idx = _intersection_inputs(seed=9)
    order = np.random.default_rng(2).permutation(len(e))
    got = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                 K_INTER, edge_order=_t(order)).numpy()
    ref = np.asarray(jf.intersection_forces(
        jnp.asarray(pos), jnp.asarray(e), jnp.asarray(knn_idx),
        jnp.asarray(sampled), K_INTER, edge_order=jnp.asarray(order)))
    np.testing.assert_allclose(got, ref, **TOL)
    plain = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                   K_INTER).numpy()
    same = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                  K_INTER, edge_order=_t(np.arange(len(e))))
    np.testing.assert_array_equal(same.numpy(), plain)
    assert not np.array_equal(got, plain)


@pytest.mark.fast
def test_intersection_forces_pair_weight():
    """JAX's pair_weight (its sharded path's mask of padded candidates)
    scales each candidate pair's repulsion; all ones changes nothing."""
    e, pos, sampled, knn_idx = _intersection_inputs(seed=11)
    w = np.random.default_rng(4).uniform(0.0, 2.0, knn_idx.size)
    w = w.astype(np.float32)
    w[::5] = 0.0
    got = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                 K_INTER, pair_weight=_t(w)).numpy()
    ref = np.asarray(jf.intersection_forces(
        jnp.asarray(pos), jnp.asarray(e), jnp.asarray(knn_idx),
        jnp.asarray(sampled), K_INTER, pair_weight=jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, **TOL)
    plain = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                   K_INTER).numpy()
    ones = tf.intersection_forces(_t(pos), _t(e), _t(knn_idx), _t(sampled),
                                  K_INTER,
                                  pair_weight=torch.ones(knn_idx.size))
    np.testing.assert_array_equal(ones.numpy(), plain)
    assert not np.allclose(got, plain)


@pytest.mark.fast
@pytest.mark.parametrize("cap,form", [(None, "coo"), (3, "coo"),
                                      (3, "plan")])
def test_spring_forces_nbtable(cap, form):
    """spring_forces_nbtable on build_neighbor_table's host table against
    JAX's and the oracle, with the COO overflow or the block-fold plan
    (tests/test_oracle_parity.py's cases for JAX's)."""
    e, n, pos = _graph(seed=3)
    nb_t = tf.build_neighbor_table(e, n, cap=cap)
    nb_j = jf.build_neighbor_table(e, n, cap=cap)
    if cap is not None:
        assert len(nb_t["overflow"]) > 0
    ov_t = ov_j = plan_t = plan_j = None
    if form == "plan":
        plan_t = tf.build_overflow_plan(nb_t["overflow"])
        plan_j = jf.build_overflow_plan(nb_j["overflow"])
        assert plan_t is not None
    elif len(nb_t["overflow"]):
        ov_t, ov_j = nb_t["overflow"], jnp.asarray(nb_j["overflow"])
    got = tf.spring_forces_nbtable(_t(pos), nb_t, K_ATTR, L_MIN, ov_t,
                                   plan_t).numpy()
    ref = np.asarray(jf.spring_forces_nbtable(
        jnp.asarray(pos), nb_j, K_ATTR, L_MIN, ov_j, _plan_j(plan_j)))
    orc = oracle.spring_forces_np(pos.astype(np.float64), e, K_ATTR, L_MIN)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, orc, **TOL)


@pytest.mark.fast
@pytest.mark.parametrize("d", [2, 3])
def test_segments_intersect_exact(d):
    rng = np.random.default_rng(d)
    pts = [rng.standard_normal((2000, d)).astype(np.float32) for _ in range(4)]
    got = t_sid(*[_t(p) for p in pts]).numpy()
    ref = np.asarray(j_sid(*[jnp.asarray(p) for p in pts]))
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all()


@pytest.mark.fast
@pytest.mark.parametrize("chunk", [64, 1000, 8192])
def test_knn_exact_and_chunked(chunk):
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((30, 3)).astype(np.float32)
    r = rng.standard_normal((3001, 3)).astype(np.float32)
    k = 9
    ei, ev = tknn.knn_exact(_t(q), _t(r), k)
    ci, cv = tknn.knn_chunked(_t(q), _t(r), k, chunk_size=chunk)
    ji, jv = jknn.knn_exact(jnp.asarray(q), jnp.asarray(r), k)
    jci, _ = jknn.knn_chunked(jnp.asarray(q), jnp.asarray(r), k,
                              chunk_size=chunk)
    assert ei.dtype == torch.int32 and ci.dtype == torch.int32
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(ei.numpy(), oracle.knn_np(q, r, k))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(cv.numpy(), ev.numpy())


@pytest.mark.fast
def test_knn_dispatch():
    q = torch.zeros((4, 2))
    r = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    idx, _ = tknn.knn(q, r, 3)
    assert idx.tolist() == [[0, 1, 2]] * 4
    # 'approx' is the one-shot tier off a TPU: exact, as JAX's there
    aidx, avals = tknn.knn(q, r, 3, strategy="approx")
    assert aidx.dtype == torch.int32 and avals.dtype == torch.float32
    assert aidx.tolist() == [[0, 1, 2]] * 4
    np.testing.assert_array_equal(avals.numpy(), [[1.0, 13.0, 41.0]] * 4)
    pidx, pvals = tknn.knn(q, r, 3, strategy="pallas")
    assert pidx.tolist() == [[0, 1, 2]] * 4
    np.testing.assert_array_equal(pvals.numpy(), [[1.0, 13.0, 41.0]] * 4)
    with pytest.raises(ValueError, match="Unknown"):
        tknn.knn(q, r, 3, strategy="bogus")
    assert tknn.EXACT_MAX_REFS == jknn.EXACT_MAX_REFS
    assert tknn.DEFAULT_CHUNK == jknn.DEFAULT_CHUNK


@pytest.mark.fast
@pytest.mark.parametrize("fast_min", [1 << 18, 100])
def test_sampling_properties(monkeypatch, fast_min):
    monkeypatch.setattr(sampling, "FAST_SAMPLE_MIN_EDGES", fast_min)
    g = torch.Generator().manual_seed(0)
    seen = np.zeros(1000, int)
    for _ in range(200):
        s = sampling.sample_indices(g, 1000, 64)
        assert s.dtype == torch.int32 and s.shape == (64,)
        a = s.numpy()
        assert len(np.unique(a)) == 64
        assert a.min() >= 0 and a.max() < 1000
        seen[a] += 1
    # uniform marginals: every index drawn, none far above its mean of 12.8
    assert seen.min() > 0 and seen.max() < 40
    whole = sampling.sample_indices(g, 10, 64)
    np.testing.assert_array_equal(whole.numpy(), np.arange(10))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(sampling.sample_indices(g1, 1000, 64),
                       sampling.sample_indices(g2, 1000, 64))
