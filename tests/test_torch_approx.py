"""The port's 'approx' kNN tier against the JAX package's, on the CPU.

Off a TPU ``jax.lax.approx_min_k`` is a sort and a slice, so JAX's approx
tier is exact there, and so is the port's: one-shot distances to refs
padded to a multiple of 512 rows at 1e30, then one exact top-k, while the
(S, E) matrix fits ``oneshot_budget_bytes``; the exact blockwise scan
beyond (forced here by setting both packages' ONESHOT_BUDGET_OVERRIDE to
0). On tie-free inputs the neighbour sets must be identical and the
distances equal at rtol=1e-6. With bfloat16 distances both packages round
each coordinate and each operation to bfloat16, whose unit roundoff is
2^-8: the neighbour sets must overlap at >= 0.95 and the distances of the
common neighbours agree at rtol=2^-5 (eight units of roundoff, for the
bfloat16 inputs, differences, squares and sums of three coordinates).
"""

import importlib

import numpy as np
import pytest
import torch

# both packages' ops/__init__ bind the name knn to the function
tknn = importlib.import_module("graphem_rapids_torch.ops.knn")
jknn = importlib.import_module("graphem_rapids_tpu.ops.knn")

BF16_RTOL = 2.0 ** -5


def _inputs(S, E, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, d)).astype(np.float32),
            rng.standard_normal((E, d)).astype(np.float32))


def _both(monkeypatch, q, r, k, oneshot, compute_dtype=None):
    """(port idx, port vals, JAX idx, JAX vals) of knn_approx."""
    import jax.numpy as jnp

    budget = None if oneshot else 0
    monkeypatch.setattr(tknn, "ONESHOT_BUDGET_OVERRIDE", budget)
    monkeypatch.setattr(jknn, "ONESHOT_BUDGET_OVERRIDE", budget)
    ti, tv = tknn.knn_approx(
        torch.from_numpy(q), torch.from_numpy(r), k, chunk_size=1024,
        compute_dtype=None if compute_dtype is None else torch.bfloat16)
    ji, jv = jknn.knn_approx(
        jnp.asarray(q), jnp.asarray(r), k, chunk_size=1024,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    return ti.numpy(), tv.numpy(), np.asarray(ji), np.asarray(jv)


@pytest.mark.fast
@pytest.mark.parametrize("oneshot", [True, False])
@pytest.mark.parametrize("E", [4096, 5037])  # 5037: ragged, padded to 5120
def test_knn_approx_matches_jax(monkeypatch, oneshot, E):
    q, r = _inputs(96, E)
    ti, tv, ji, jv = _both(monkeypatch, q, r, 16, oneshot)
    assert ti.dtype == np.int32 and tv.dtype == np.float32
    assert ti.shape == ji.shape == (96, 16)
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    # and both are exact: the neighbours of knn_exact
    ei, ev = tknn.knn_exact(torch.from_numpy(q), torch.from_numpy(r), 16)
    np.testing.assert_array_equal(np.sort(ti, axis=1),
                                  np.sort(ei.numpy(), axis=1))


@pytest.mark.fast
def test_oneshot_pad_rows_as_jax():
    """k beyond the refs reaches the 1e30 pad rows, as in JAX: indices
    past E at an infinite distance."""
    import jax.numpy as jnp

    q, r = _inputs(8, 5)
    ti, tv = tknn._oneshot_approx(torch.from_numpy(q), torch.from_numpy(r), 7)
    ji, jv = jknn._oneshot_approx(jnp.asarray(q), jnp.asarray(r), 7)
    ji, jv = np.asarray(ji), np.asarray(jv)
    np.testing.assert_array_equal(np.sort(ti.numpy()[:, :5], axis=1),
                                  np.sort(ji[:, :5], axis=1))
    np.testing.assert_allclose(tv.numpy()[:, :5], jv[:, :5], rtol=1e-6)
    for idx, vals in ((ti.numpy(), tv.numpy()), (ji, jv)):
        assert (idx[:, 5:] >= 5).all() and (idx[:, 5:] < 512).all()
        assert np.isinf(vals[:, 5:]).all()


@pytest.mark.fast
def test_knn_approx_bfloat16_matches_jax(monkeypatch):
    q, r = _inputs(128, 6000, seed=1)
    k = 16
    ti, tv, ji, jv = _both(monkeypatch, q, r, k, True,
                           compute_dtype="bfloat16")
    assert tv.dtype == np.float32
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(ti, ji)])
    assert overlap >= 0.95, overlap
    for a, va, b, vb in zip(ti, tv, ji, jv):
        common = np.intersect1d(a, b)
        da = dict(zip(a, va))
        db = dict(zip(b, vb))
        np.testing.assert_allclose([da[c] for c in common],
                                   [db[c] for c in common], rtol=BF16_RTOL)
    # the scan beyond the budget computes in the inputs' dtype, as JAX's
    si, sv, sji, sjv = _both(monkeypatch, q, r, k, False,
                             compute_dtype="bfloat16")
    np.testing.assert_array_equal(np.sort(si, axis=1), np.sort(sji, axis=1))
    np.testing.assert_allclose(sv, sjv, rtol=1e-6)


@pytest.mark.fast
def test_budget_and_dispatch(monkeypatch):
    monkeypatch.setattr(tknn, "ONESHOT_BUDGET_OVERRIDE", None)
    # the CPU budget: 4 GiB, the JAX package's, over the eager peak
    assert tknn.oneshot_budget_bytes("cpu") == int(
        4 * 1024**3 * tknn.ONESHOT_HBM_FRACTION / tknn.ONESHOT_PEAK_FACTOR)
    monkeypatch.setattr(tknn, "ONESHOT_BUDGET_OVERRIDE", 123)
    assert tknn.oneshot_budget_bytes() == 123
    assert tknn.ONESHOT_HBM_FRACTION == jknn.ONESHOT_HBM_FRACTION
    # 'auto' above EXACT_MAX_REFS: the scan on the CPU, as in JAX
    q, r = _inputs(4, tknn.EXACT_MAX_REFS + 1, seed=2)
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    ai, av = tknn.knn(qt, rt, 5)
    ci, cv = tknn.knn_chunked(qt, rt, 5)
    assert torch.equal(ai, ci) and torch.equal(av, cv)


@pytest.mark.fast
def test_sharded_approx_local_one_rank_matches_jax():
    """use_approx_local=True on a one-rank mesh against JAX's 4-device
    mesh: the same trajectory from the same start and samples."""
    import jax.numpy as jnp

    from graphem_rapids_tpu.ops.forces import build_neighbor_table as jbnt
    from graphem_rapids_tpu.parallel import build_sharded_step as jbuild
    from graphem_rapids_tpu.parallel import make_mesh as jmesh
    from graphem_rapids_tpu.parallel.sharded_step import pad_edges as jpad
    from graphem_rapids_torch.ops.forces import build_neighbor_table
    from graphem_rapids_torch.parallel import make_mesh
    from graphem_rapids_torch.parallel.sharded_step import (
        build_sharded_step,
        pad_edges,
    )

    rng = np.random.default_rng(4)
    n = 300
    e = np.concatenate([np.column_stack([p, np.roll(p, -1)])
                        for p in (rng.permutation(n) for _ in range(3))])
    e = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
    E = len(e)
    kw = dict(n_components=3, k_attr=0.5, L_min=10.0, k_inter=0.1,
              n_neighbors=8, sample_size=64, fused_refs=True,
              knn_comm="all_gather", use_approx_local=True, return_raw=True)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    samples = [rng.permutation(E)[:64] for _ in range(5)]

    ep, vp = pad_edges(e, 1)
    _, _, ops, raw = build_sharded_step(make_mesh(device="cpu"), n, E,
                                        nb=build_neighbor_table(e, n), **kw)
    port = torch.from_numpy(pos)
    for s in samples:
        port = raw(port, torch.from_numpy(ep).long(), torch.from_numpy(vp),
                   torch.from_numpy(s), ops)

    jep, jvp = jpad(e, 4)
    _, _, jops, jraw = jbuild(jmesh(4), n, E,
                              nb=jbnt(e, n, to_device=False), **kw)
    ref = jnp.asarray(pos)
    for s in samples:
        ref = jraw(ref, jnp.asarray(jep), jnp.asarray(jvp),
                   jnp.asarray(s, jnp.int32), jops)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
