"""The accumulator's static form on star-heavy hub block plans, against the
JAX package and the CPU's index_add_.

A hub block plan of hubs with thousands of overflow pairs among many small
ones (B = 32, as the 1M heavy-tail graph's) goes through the step's
``apply_overflow_plan`` and the Chebyshev SpMV's ``_overflow_correct``. On
the CPU the port is bit-equal to its index_add_ form (the CPU's loop adds a
row's terms in ascending order, which the card's static kernel keeps), and
it equals the JAX package's op within the tolerances of the existing
parity tests: forces at rtol=1e-5, atol=1e-5 (tests/test_torch_ops.py), the
SpMV's overflow at rtol=1e-3, atol=1e-4 (tests/test_torch_spectral.py),
which cover the summation order. The static kernel's own run bounds are
held against np.unique in tests/test_torch_determinism.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch.ops import forces as tf
from graphem_rapids_torch.ops import laplacian as lap
from graphem_rapids_torch.ops import segment as seg
from graphem_rapids_tpu.ops import forces as jf
from graphem_rapids_tpu.ops import laplacian as jlap

K_ATTR, L_MIN = 0.5, 10.0
FORCE_TOL = dict(rtol=1e-5, atol=1e-5)
SPMV_TOL = dict(rtol=1e-3, atol=1e-4)
# hubs of thousands of overflow pairs, and many with a few
BIG_HUBS = (6000, 3500, 2000)
SMALL_HUBS, SMALL_PAIRS = 400, (3, 40)


def _star_overflow(n=12_000, seed=0):
    """(overflow (O, 2) int64 rows ascending, n): BIG_HUBS hubs with that
    many pairs each and SMALL_HUBS hubs with SMALL_PAIRS pairs each, the
    neighbours drawn from a seed."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([BIG_HUBS, rng.integers(*SMALL_PAIRS,
                                                    SMALL_HUBS)])
    hubs = np.sort(rng.choice(n, len(counts), replace=False))
    rows = np.repeat(hubs, counts)
    nbrs = rng.integers(0, n, len(rows))
    nbrs = np.where(nbrs == rows, (nbrs + 1) % n, nbrs)
    return np.column_stack([rows, nbrs]).astype(np.int64), n


def _star_adjacency(n=12_000, seed=1):
    """A ring with the hubs of _star_overflow joined to their neighbours:
    the SpMV's table cap leaves them a hub block plan."""
    ov, _ = _star_overflow(n, seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    e = np.concatenate([ring, ov])
    e = np.unique(np.sort(e, axis=1), axis=0)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    a = (a + a.T).tocsr()
    a.data[:] = 1
    return a


def _runs(keys):
    _, counts = np.unique(np.asarray(keys), return_counts=True)
    return counts


@pytest.mark.fast
def test_star_plan_step_sum_equals_index_add_and_jax():
    overflow, n = _star_overflow()
    plan = tf.build_overflow_plan(overflow)
    want_plan = jf.build_overflow_plan(overflow)
    assert plan["block"] == want_plan["block"] == 32
    for key in ("pairs", "block_hub", "hub_ids", "pad_count"):
        np.testing.assert_array_equal(plan[key], np.asarray(want_plan[key]))
    runs = _runs(plan["block_hub"])
    assert runs.max() >= BIG_HUBS[0] // 32 >= seg.LONG_RUN
    assert (runs < seg.LONG_RUN).sum() > 100  # short runs beside long ones
    rng = np.random.default_rng(2)
    pos = (rng.standard_normal((n, 3)) * 3).astype(np.float32)
    base = rng.standard_normal((n, 3)).astype(np.float32)
    plan_t = {k: (v if k == "block" else torch.from_numpy(
        np.asarray(v)).long()) for k, v in plan.items()}
    pos_t = torch.from_numpy(pos)
    got = tf.apply_overflow_plan(torch.from_numpy(base.copy()), pos_t,
                                 plan_t, K_ATTR, L_MIN)
    fo = tf._overflow_spring(pos_t, plan_t["pairs"], K_ATTR, L_MIN)
    blk = fo.reshape(-1, 32, 3).sum(dim=1)
    hub = torch.zeros(len(plan["hub_ids"]), 3).index_add_(
        0, plan_t["block_hub"], blk)
    want = torch.from_numpy(base.copy()).index_add(0, plan_t["hub_ids"], hub)
    assert torch.equal(got, want)
    ref = jf.apply_overflow_plan(
        jnp.asarray(base), jnp.asarray(pos),
        {k: (v if k == "block" else jnp.asarray(v))
         for k, v in want_plan.items()}, K_ATTR, L_MIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FORCE_TOL)


@pytest.mark.fast
@pytest.mark.parametrize("s", [3, 8])
def test_star_plan_spmv_overflow_equals_index_add_and_jax(s):
    A = _star_adjacency()
    plan = lap._adjacency_matvec_plan(A)
    jplan = jlap._adjacency_matvec_plan(A)
    ov, jov = plan["ov_plan"], jplan["ov_plan"]
    assert ov is not None and ov["block"] == jov["block"] == 32
    np.testing.assert_array_equal(ov["block_hub"].numpy(),
                                  np.asarray(jov["block_hub"]))
    assert _runs(ov["block_hub"]).max() >= seg.LONG_RUN
    n = A.shape[0]
    X = np.random.default_rng(3).standard_normal((n, s)).astype(np.float32)
    Y_ext = torch.from_numpy(np.concatenate([X, np.zeros((1, s), X.dtype)]))
    AY = torch.zeros(n, s)
    got = lap._overflow_correct(AY.clone(), Y_ext, plan)
    blk = Y_ext[ov["nbr"]].reshape(-1, 32, s).sum(dim=1)
    hub = torch.zeros(len(ov["hub_ids"]), s).index_add_(
        0, ov["block_hub"], blk)
    want = AY.clone().index_add_(0, ov["hub_ids"], hub)
    assert torch.equal(got, want)
    ref = jlap._overflow_correct(jnp.zeros((n, s), jnp.float32),
                                 jnp.asarray(X), jplan["overflow"], jov, n,
                                 jov["block"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SPMV_TOL)
    # and the overflow is the adjacency's tail: A @ X where the table stops
    np.testing.assert_allclose(
        (Y_ext[plan["table"]].sum(dim=1) + got).numpy(), A @ X, **SPMV_TOL)
