"""The bin-fold kNN of the PyTorch port against the JAX Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version
(binfold_bins_reference); the JAX kernel runs in Pallas interpret mode,
which knn_binfold selects by itself off a TPU. Inputs are tie-free random
floats made with numpy, so indices must be equal; values are held at
rtol=1e-6 (the JAX interpreter may round the per-coordinate sum
differently in the last bit). The CUDA kernel itself is compared with the
plain version, bit for bit, by the tests marked ``cuda``, which need a card.
The card's machine has no JAX, so the JAX package is imported inside the
tests that use it, and the card tests run there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_binfold.py
"""

import numpy as np
import pytest
import torch

from graphem_rapids_torch.ops import knn_binfold as tbf


def _jax():
    """(jax.numpy, the JAX package's knn_binfold module)."""
    jnp = pytest.importorskip("jax.numpy")
    return jnp, pytest.importorskip("graphem_rapids_tpu.ops.knn_binfold")


CASES = [  # tests/test_knn_binfold.py::test_binfold_matches_exact
    (64, 5000, 3, 8, 256, 4),
    (32, 1000, 2, 5, 128, 3),
    (16, 300, 4, 17, 128, 2),
    (64, 9001, 3, 8, 256, 4),
    (7, 500, 3, 4, 128, 2),
]


def _inputs(S, E, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, d)).astype(np.float32) * 10
    r = rng.normal(size=(E, d)).astype(np.float32) * 10
    return q, r


@pytest.mark.fast
@pytest.mark.parametrize("S,E,d,k,T,G", CASES)
def test_plain_matches_jax_kernel(S, E, d, k, T, G):
    jnp, jbf = _jax()
    q, r = _inputs(S, E, d)
    ji, jv = jbf.knn_binfold(jnp.asarray(q), jnp.asarray(r), k, T=T, G=G)
    launches = tbf.knn_binfold.launches
    ti, tv = tbf.knn_binfold(torch.from_numpy(q), torch.from_numpy(r), k,
                             T=T, G=G)
    assert tbf.knn_binfold.launches == launches  # the CPU runs no kernel
    assert ti.dtype == torch.int32 and ti.shape == (S, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.fast
def test_plain_matches_jax_segments():
    jnp, jbf = _jax()
    rng = np.random.default_rng(4)
    S, E, d, k = 16, 2000, 3, 10
    q = rng.standard_normal((S, d)).astype(np.float32)
    r = rng.standard_normal((E, d)).astype(np.float32)
    ji, jv = jbf._binfold_segments(jnp.asarray(q), jnp.asarray(r), k, 128, 4,
                                   S, seg=512, n_seg=4, interpret=True)
    ti, tv = tbf._binfold_segments(torch.from_numpy(q), torch.from_numpy(r),
                                   k, 128, 4, seg=512, n_seg=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.fast
def test_plain_bins_pad_and_tie_rules():
    """A bin that sees only 1e30-padded refs keeps (3e38, 0); the kernel's
    own 1e15 pad past E gives a finite distance and an index >= E; equal
    distances keep the lowest position."""
    T, G = 128, 2
    q = torch.zeros((1, 2))
    refs = torch.full((300, 2), 1e30)
    refs[5] = torch.tensor([1.0, 0.0])
    refs[5 + T * G] = torch.tensor([0.0, 1.0])  # same bin, same distance
    G_eff, n_super = tbf._geometry(300, T, G)
    vals, idx = tbf.binfold_bins_reference(q, refs, T, G_eff, n_super)
    assert (G_eff, n_super) == (2, 2)
    assert vals[0, 5] == 1.0 and idx[0, 5] == 5
    # bin 6 saw refs 6 and 262, both 1e30 (+inf): it keeps the init
    assert vals[0, 6] == 3.0e38 and idx[0, 6] == 0
    # bin 50 saw ref 50 (+inf) and position 306 >= E (the 1e15 pad)
    assert idx[0, 50] == 306 and 1e29 < vals[0, 50] < 1e31
    # bin 200 (group 1, lane 72) saw ref 200 (+inf) and position 456
    assert idx[0, 200] == 456 and 1e29 < vals[0, 200] < 1e31
    assert torch.isinf(vals).sum() == 0
    only_inf = torch.full((T * G, 2), 1e30)
    v2, i2 = tbf.binfold_bins_reference(q, only_inf, T, G, 1)
    assert (v2 == 3.0e38).all() and (i2 == 0).all()


@pytest.mark.fast
def test_params_for_equals_jax():
    _, jbf = _jax()
    for k in (1, 5, 16, 17, 30, 48, 100):
        for recall in (0.3, 0.9, 0.95, 0.99, 0.9999):
            assert tbf.params_for(k, recall) == jbf.params_for(k, recall)
    assert tbf.params_for(16, 0.95, T=1024) == jbf.params_for(16, 0.95, T=1024)
    for name in ("MAX_REFS", "MAX_SEGMENTS", "MAX_REFS_SEGMENTED", "MAX_DIM",
                 "MAX_K", "_PAD_COORD", "_BIG"):
        assert getattr(tbf, name) == getattr(jbf, name), name


@pytest.mark.fast
def test_k_exceeding_bins_raises():
    q = torch.zeros((8, 3))
    r = torch.zeros((300, 3))
    with pytest.raises(ValueError, match="bins"):
        tbf.knn_binfold(q, r, 24 * 128 + 1)


@pytest.mark.fast
def test_max_refs_raises():
    class FakeRefs:
        shape = (tbf.MAX_REFS_SEGMENTED + 1, 3)

    with pytest.raises(ValueError, match="references"):
        tbf.knn_binfold(torch.zeros((8, 3)), FakeRefs(), 5)


@pytest.mark.fast
def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch path never hands host pointers to the kernel."""
    before = tbf.knn_binfold.launches
    with pytest.raises(ValueError, match="CUDA"):
        tbf.binfold_bins_cuda(torch.zeros((4, 3)), torch.zeros((300, 3)),
                              128, 2, 2)
    assert tbf.knn_binfold.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bin-fold kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,E,d,T,G", [
    (512, 800_000, 3, 2048, 24),
    (7, 9001, 2, 2048, 24),
    (7, 20_077, 4, 2048, 24),
])
def test_kernel_matches_plain(cuda_device, S, E, d, T, G):
    q, r = _inputs(S, E, d, seed=1)
    r[::37] = 1e30  # non-edge ref slots
    qt = torch.from_numpy(q).to(cuda_device)
    rt = torch.from_numpy(r).to(cuda_device)
    G_eff, n_super = tbf._geometry(E, T, G)
    before = tbf.knn_binfold.launches
    kv, ki = tbf.binfold_bins_cuda(qt, rt, T, G_eff, n_super)
    torch.cuda.synchronize()
    assert tbf.knn_binfold.launches == before + 1
    pv, pi = tbf.binfold_bins_reference(qt, rt, T, G_eff, n_super)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
