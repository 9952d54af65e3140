"""The factory and utils of the PyTorch port against the JAX package.

Strategy selection is compared decision by decision: the accelerator probe
and the device count are patched to the same answers on both sides
(a CUDA card in the port, a TPU in the JAX package). Chunk sizes are
compared on the CPU, where both use the 4 GiB host budget. The factory-built
engine with backend='cuvs' (the 'pallas' strategy) is held against the JAX
factory's engine with injected samples, at the tolerances of
tests/test_torch_embedder.py: rtol=1e-4, atol=1e-5 after 5 steps and the
JAX suite's multi-step rtol=5e-3, atol=5e-4 after 20 (the force scatters
sum in another order).
"""

import itertools
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphem_rapids_torch as grt
from graphem_rapids_torch.utils import backend_selection as tbs
from graphem_rapids_torch.utils import memory_management as tmm
from graphem_rapids_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parent.parent

STRATEGY_NAMES = (None, "auto", "exact", "chunked", "approx", "binfold",
                  "pallas", "sharded", "pytorch", "cuda", "gpu", "tpu", "cpu",
                  "cuvs", "rapids")
PARAMS = dict(L_min=10.0, k_attr=0.5, k_inter=0.1, n_neighbors=5)


def _jax_bs():
    return pytest.importorskip("graphem_rapids_tpu.utils.backend_selection")


def _patch_hardware(monkeypatch, jbs, accel, n_devices):
    monkeypatch.setattr(jbs, "check_tpu_availability", lambda: accel)
    monkeypatch.setattr(jbs, "check_device_count", lambda: n_devices)
    monkeypatch.setattr(tbs, "check_cuda_availability", lambda: accel)
    monkeypatch.setattr(tbs, "check_device_count", lambda: n_devices)


def _ring(n, chords=0, seed=0):
    rng = np.random.default_rng(seed)
    e = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    if chords:
        e = np.concatenate([e, rng.integers(0, n, (chords, 2))])
    e = e[e[:, 0] != e[:, 1]]
    i, j = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    a = sp.coo_matrix((np.ones(len(e)), (i, j)), shape=(n, n)).tocsr()
    a.data[:] = 1
    return a + a.T


@pytest.mark.fast
@pytest.mark.parametrize("accel,n_devices", [(True, 1), (True, 4),
                                             (False, 1), (False, 8)])
def test_decision_tree_matches_jax(monkeypatch, accel, n_devices):
    jbs = _jax_bs()
    _patch_hardware(monkeypatch, jbs, accel, n_devices)
    grid = itertools.product(
        (500, 20_000, 150_000, 2_000_000),     # n
        (None, 1_000, 60_000, 900_000),        # n_edges
        STRATEGY_NAMES,                        # force_backend
        (None, 0.001, 100.0),                  # memory_limit (GB)
        (None, 1, 4),                          # mesh_devices
        (True, False),                         # prefer the accelerator
    )
    checked = 0
    for n, E, force, mem, mesh, prefer in grid:
        kw = dict(n_vertices=n, n_components=3, n_edges=E,
                  force_backend=force, prefer_tpu=prefer, memory_limit=mem,
                  mesh_devices=mesh)
        j = jbs.get_optimal_backend(jbs.BackendConfig(**kw))
        t = tbs.get_optimal_backend(tbs.BackendConfig(**kw))
        assert t == j, kw
        checked += 1
    assert checked == 4 * 4 * len(STRATEGY_NAMES) * 3 * 3 * 2


@pytest.mark.fast
@pytest.mark.parametrize("env", [
    {},
    {"GRAPHEM_BACKEND": "cuvs"},
    {"GRAPHEM_BACKEND": "cpu", "GRAPHEM_VERBOSE": "true"},
    {"GRAPHEM_PREFER_GPU": "false"},
    {"GRAPHEM_PREFER_TPU": "0"},
    {"GRAPHEM_MEMORY_LIMIT": "0.01"},
    {"GRAPHEM_MEMORY_LIMIT": "64", "GRAPHEM_PREFER_GPU": "yes"},
])
def test_env_config_matches_jax(monkeypatch, env):
    jbs = _jax_bs()
    _patch_hardware(monkeypatch, jbs, True, 1)
    for name in ("GRAPHEM_BACKEND", "GRAPHEM_PREFER_GPU", "GRAPHEM_PREFER_TPU",
                 "GRAPHEM_MEMORY_LIMIT", "GRAPHEM_VERBOSE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for n, E in ((300, 1_000), (30_000, 120_000), (500_000, 2_000_000)):
        j = jbs.get_default_config(n, 3, n_edges=E)
        t = tbs.get_default_config(n, 3, n_edges=E)
        assert vars(t) == vars(j)
        assert tbs.get_optimal_backend(t) == jbs.get_optimal_backend(j)


@pytest.mark.fast
def test_config_validation_and_scores_match_jax():
    jbs = _jax_bs()
    for alias, target in tbs.LEGACY_ALIASES.items():
        assert jbs.LEGACY_ALIASES[alias] == target
    assert tbs.VALID_STRATEGIES == jbs.VALID_STRATEGIES
    assert tbs.BackendConfig(10, force_backend="cuvs").force_backend == "pallas"
    assert tbs.BackendConfig(10, force_backend="rapids").force_backend == "pallas"
    for bad in (dict(n_vertices=0), dict(n_vertices=10, n_components=-1),
                dict(n_vertices=10, force_backend="nope")):
        with pytest.raises(ValueError):
            tbs.BackendConfig(**bad)
    for n, d in ((100, 2), (10**6, 3), (10**7, 50)):
        assert tbs.get_data_complexity_score(n, d) == \
            jbs.get_data_complexity_score(n, d)
        for strategy in ("exact", "chunked"):
            for E in (None, 5 * n):
                assert tbs.estimate_memory_usage(n, d, strategy, n_edges=E) \
                    == jbs.estimate_memory_usage(n, d, strategy, n_edges=E)


@pytest.mark.fast
def test_chunk_size_matches_jax_on_cpu():
    jmm = pytest.importorskip("graphem_rapids_tpu.utils.memory_management")
    for strategy in ("auto", "exact", "chunked", "binfold", "pallas"):
        for n, d, sample in ((600, 3, 1024), (10**6, 2, 256), (50, 4, 4096),
                             (10**5, 3, 64)):
            assert tmm.get_optimal_chunk_size(
                n, d, strategy, sample, device="cpu"
            ) == jmm.get_optimal_chunk_size(n, d, strategy, sample)
    assert tmm.get_optimal_chunk_size(600, 3, "pallas", device="cpu") == 2048
    assert tmm.get_optimal_chunk_size(600, 3, "chunked", device="cpu") == 65536
    for items, size in ((10, 8), (10**9, 4096), (5000, 1)):
        assert tmm.adaptive_batch_size(items, size, device="cpu") == \
            jmm.adaptive_batch_size(items, size)
    for strategy in ("auto", "pallas"):
        for n in (1000, 10**8):
            assert tmm.check_memory_requirements(
                n, 3, strategy, device="cpu"
            ) == jmm.check_memory_requirements(n, 3, strategy)


@pytest.mark.fast
def test_cuda_pallas_tile_is_shared_memory_bound(monkeypatch):
    """On a card the 'pallas' tile is capped by one block's shared memory
    (a ref tile of n_components floats per ref), not by the TPU's VMEM."""
    monkeypatch.setattr(tmm, "get_device_memory_info", lambda device=None: {
        "bytes_in_use": 0, "bytes_limit": 80 * 1024**3, "bytes_free": None})
    c = tmm.get_optimal_chunk_size(10**6, 3, "pallas", device="cuda")
    assert c == (tmm.SMEM_PER_BLOCK // 12) // 128 * 128
    assert tmm.get_optimal_chunk_size(10**6, 3, "chunked",
                                      device="cuda") == 65536


@pytest.mark.fast
def test_memory_observers_on_cpu():
    info = tmm.get_device_memory_info("cpu")
    assert info == {"bytes_in_use": None, "bytes_limit": None,
                    "bytes_free": None}
    tmm.cleanup_device_memory()

    @tmm.monitor_memory_usage
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    with tmm.MemoryManager(cleanup_on_exit=True, device="cpu") as mm:
        pass
    assert mm.before == mm.after == info


@pytest.mark.fast
def test_profiling_helpers(tmp_path):
    t = tprof.time_fn(lambda x: x * 2.0, torch.ones((64, 64)), reps=3,
                      warmup=1)
    assert t > 0
    with tprof.trace(tmp_path / "tr") as prof:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    assert len(prof.key_averages()) > 0


@pytest.mark.fast
@pytest.mark.parametrize("strategy", ["exact", "chunked", "binfold", "pallas"])
def test_batch_size_matches_jax(strategy):
    gr = pytest.importorskip("graphem_rapids_tpu")
    adj = _ring(600, chords=600, seed=1)
    kw = dict(n_components=3, seed=0, verbose=False, init="random",
              knn_strategy=strategy)
    ref = gr.GraphEmbedderTPU(adj, **kw)
    port = grt.GraphEmbedderTorch(adj, device="cpu", **kw)
    assert port.batch_size == ref.batch_size
    expected = 2048 if strategy == "pallas" else 65536
    assert port.batch_size == expected
    assert grt.GraphEmbedderTorch(adj, device="cpu", batch_size=777,
                                  **kw).batch_size == 777


@pytest.mark.fast
@pytest.mark.parametrize("backend", ["cuvs", "rapids", "pallas"])
def test_factory_resolves_pallas(backend):
    adj = _ring(200, chords=100)
    emb = grt.create_graphem(adj, n_components=3, backend=backend,
                             device="cpu", verbose=False, seed=0)
    assert isinstance(emb, grt.GraphEmbedderTorch)
    assert emb._strategy == "pallas" and not emb._fused_refs_active
    assert grt.GraphEmbedderCuVS is grt.GraphEmbedderPyTorch \
        is grt.GraphEmbedderTorch


@pytest.mark.fast
def test_factory_defaults_and_options(caplog):
    adj = _ring(300)
    assert grt.create_graphem(adj, device="cpu", verbose=False,
                              seed=0)._strategy == "exact"
    assert grt.create_graphem(adj, backend="cpu", device="cpu",
                              verbose=False, seed=0)._strategy == "chunked"
    with caplog.at_level(logging.INFO, logger="graphem_rapids_torch"):
        emb = grt.create_graphem(adj, backend="cuvs", index_type="ivf_pq",
                                 device="cpu", verbose=False, seed=0)
    assert "index_type" in caplog.text and emb._strategy == "pallas"
    with pytest.raises(ValueError, match="k <= 128"):
        grt.create_graphem(adj, backend="cuvs", device="cpu", verbose=False,
                           n_neighbors=128)
    with pytest.raises(ValueError, match="force_backend"):
        grt.create_graphem(adj, backend="nope", device="cpu")


@pytest.mark.fast
def test_factory_sharded_raises():
    """The sharded tier is ported; what it leaves out still raises.
    ref_order='slot' is ported to it too (tests/test_torch_sharded.py holds
    it against JAX): the factory builds it."""
    adj = _ring(100)
    emb = grt.create_graphem(adj, backend="sharded", device="cpu",
                             ref_order="slot", verbose=False, init="random")
    # the flat slot-major table rides as the one bucket, (cap, n)
    (table_t,) = emb._step_ops["btables"]
    assert emb.ref_order == "slot" and torch.equal(
        table_t, torch.as_tensor(emb._nb["table_t"]).long())
    with pytest.raises(ValueError, match="knn_comm"):
        grt.create_graphem(adj, backend="sharded", device="cpu",
                           knn_comm="nccl")
    with pytest.raises(ValueError, match="process group"):
        grt.make_mesh(4)


@pytest.mark.fast
def test_factory_builds_sharded_on_one_rank():
    adj = _ring(300, chords=200)
    emb = grt.create_graphem(adj, n_components=3, backend="sharded",
                             device="cpu", verbose=False, seed=0,
                             init="random")
    assert isinstance(emb, grt.ShardedGraphEmbedder)
    assert emb.mesh.world_size == 1 and emb.mesh.group is None
    assert emb._resolved_strategy() == "sharded"
    mesh = grt.make_mesh(device="cpu")
    emb2 = grt.create_graphem(adj, n_components=3, backend="sharded",
                              mesh=mesh, verbose=False, seed=0,
                              init="random", knn_comm="ring")
    assert emb2.mesh is mesh and emb2.knn_comm == "ring"
    # other strategies ignore mesh=, as the JAX factory does
    assert type(grt.create_graphem(adj, mesh=mesh, device="cpu",
                                   verbose=False, seed=0)) \
        is grt.GraphEmbedderTorch
    pos = emb.run_layout(3)
    assert np.isfinite(pos).all()


@pytest.mark.fast
def test_device_count_is_process_group_ranks(monkeypatch):
    """Four cards but no process group: nothing to shard over, so a 1M
    vertex graph takes the single-card tier; four ranks take 'sharded'."""
    from graphem_rapids_torch.utils.backend_selection import dist

    monkeypatch.setattr(tbs, "check_cuda_availability", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    config = tbs.BackendConfig(n_vertices=1_000_000, n_components=3,
                               n_edges=3_999_991)
    assert tbs.check_device_count() == 1
    assert tbs.get_optimal_backend(config) == "auto"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    assert tbs.check_device_count() == 4
    assert tbs.get_optimal_backend(config) == "sharded"
    info = grt.get_backend_info()
    assert info["distributed_ranks"] == 4
    assert info["recommended_backend"] == "sharded"


@pytest.mark.fast
@pytest.mark.parametrize("backend", [None, "auto", "exact", "chunked", "cpu",
                                     "binfold", "pallas", "cuvs"])
def test_factory_needs_a_card_without_cpu(monkeypatch, backend):
    """No card and no device='cpu': every strategy raises, 'chunked'
    included (the JAX factory would move 'chunked' to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adj = _ring(50_000, chords=200_000)  # large: the host tier is 'chunked'
    with pytest.raises(RuntimeError, match="CUDA"):
        grt.create_graphem(adj, backend=backend, verbose=False, seed=0,
                           init="random")


@pytest.mark.fast
def test_backend_info_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = grt.get_backend_info()
    assert info["cuda_available"] is False
    assert info["cuda_device_count"] == 0 and info["cuda_device_name"] is None
    assert info["torch_version"] == torch.__version__
    assert info["recommended_backend"] == "chunked"


@pytest.mark.fast
def test_backend_info_console_entry_and_banner(monkeypatch, capsys):
    """graphem-torch-info prints one status line and the strategy without
    a card; the import banner is printed only under
    GRAPHEM_RAPIDS_QUIET=false."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grt.backend_info_main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"GraphEm Rapids torch v{grt.__version__}")
    assert f"torch {torch.__version__}" in lines[0] and "CUDA ✗" in lines[0]
    assert lines[1] == "Recommended strategy: CHUNKED"
    code = "import graphem_rapids_torch"
    for quiet, printed in (("false", True), ("true", False)):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["GRAPHEM_RAPIDS_QUIET"] = quiet
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert ("Recommended strategy:" in out.stdout) == printed


@pytest.mark.fast
@pytest.mark.parametrize("fused", [False, True])
def test_factory_trajectory_matches_jax(fused):
    """backend='cuvs' on both factories: 5 and 20 injected-sample steps."""
    gr = pytest.importorskip("graphem_rapids_tpu")
    adj = _ring(300, chords=500, seed=4)
    kw = dict(n_components=3, seed=7, verbose=False, sample_size=64,
              init="random", fused_midpoints=fused or None, **PARAMS)
    ref = gr.create_graphem(adj, backend="cuvs", **kw)
    port = grt.create_graphem(adj, backend="cuvs", device="cpu", **kw)
    assert port._strategy == "pallas" == ref._resolved_strategy()
    assert port._fused_refs_active is fused is ref._fused_refs_active
    start = np.random.default_rng(7).standard_normal(
        (port.n, 3)).astype(np.float32)
    ref.positions = start
    port.positions = start
    rng = np.random.default_rng(3)
    for step in range(1, 21):
        sampled = rng.permutation(ref.n_edges)[:64]
        ref.update_positions(sample_indices=sampled)
        port.update_positions(sample_indices=sampled)
        if step == 5:
            np.testing.assert_allclose(port.positions, ref.positions,
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.positions, ref.positions,
                               rtol=5e-3, atol=5e-4)
