"""The port at the JAX package's single-card scale tiers, at small sizes.

Past ``MAX_REFS`` = 2^24 refs the bin fold runs in segments, each launched
on its own and merged by an exact top-k, and past 10^7 rows the force
accumulator's cluster kernel sorts each cluster's range of rows in three
radix passes. Neither happens at the sizes the other tests use. Here:

- the engine's full step in the segmented regime: both packages'
  ``MAX_REFS`` and ``MAX_REFS_SEGMENTED`` lowered by a fixture (the JAX
  package's module attributes are patched for the test, its files are not
  touched), so that a graph of a few thousand vertices takes three or
  more segments; both engines take the same injected samples from the
  same start, and the positions agree at rtol=1e-4, atol=1e-5;
- the segment rule: the port's ``segments`` against the (seg, n_seg) that
  the JAX package's knn_binfold hands its segmented kernel;
- the accumulator's numpy model of its radix passes (tests/
  test_torch_determinism.py) at the spans of 10M, 30M and 100M rows over
  an H100's 7 clusters: three passes, and the modeled order the stable
  sort's;
- scripts/torch_scale_tiers.py's graph builders against the JAX
  experiment scripts' build_adj at a small N (their module constants
  patched, their graph caches sent to a temporary directory): equal CSR
  structure, values and dtypes; and the script itself end to end on the
  CPU at ``--shrink``, one process a tier, the same seed giving the same
  positions' bytes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from graphem_rapids_torch import GraphEmbedderTorch
from graphem_rapids_torch.ops import knn_binfold as tbf
from graphem_rapids_torch.ops import segment as seg

REPO = Path(__file__).resolve().parent.parent
PARAMS = dict(n_components=3, L_min=10.0, k_attr=0.5, k_inter=0.1,
              n_neighbors=15, sample_size=64, verbose=False)
SMALL_MAX_REFS = 4096


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tiers = _load("scripts/torch_scale_tiers.py", "torch_scale_tiers")


@pytest.fixture
def small_segments(monkeypatch):
    """Both packages' bin fold segmented past SMALL_MAX_REFS refs."""
    jbf = pytest.importorskip("graphem_rapids_tpu.ops.knn_binfold")
    for mod in (tbf, jbf):
        monkeypatch.setattr(mod, "MAX_REFS", SMALL_MAX_REFS)
        monkeypatch.setattr(mod, "MAX_REFS_SEGMENTED",
                            SMALL_MAX_REFS * mod.MAX_SEGMENTS)
    return jbf


@pytest.mark.fast
@pytest.mark.parametrize("n,chords", [(2000, 4000), (1500, 5000)])
def test_segmented_step_matches_jax(small_segments, n, chords):
    """The engine's fused binfold step over three or more K1 segments, the
    port against the JAX package, from the same start on the same
    samples."""
    import graphem_rapids_tpu as gr

    adj = tiers.ring_graph(n, chords)
    kw = dict(PARAMS, seed=5, init="random", knn_strategy="binfold")
    ref = gr.GraphEmbedderTPU(adj, **kw)
    port = GraphEmbedderTorch(adj, device="cpu", **kw)
    refs = len(port._nb["ref_edge"])
    T, _ = tbf.params_for(port._k_eff, port.knn_recall_target)
    assert port._fused_refs_active and ref._fused_refs_active
    assert refs == len(ref._nb["ref_edge"])
    assert tbf.segments(refs, T)[1] >= 3
    start = np.random.default_rng(1).standard_normal(
        (port.n, 3)).astype(np.float32)
    ref.positions = start
    port.positions = start
    rng = np.random.default_rng(2)
    for _ in range(3):
        sampled = rng.permutation(port.n_edges)[:PARAMS["sample_size"]]
        ref.update_positions(sample_indices=sampled)
        port.update_positions(sample_indices=sampled)
    np.testing.assert_allclose(port.positions, ref.positions, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.fast
@pytest.mark.parametrize("E,T", [(4097, 2048), (8192, 2048), (8193, 2048),
                                 (17_050, 2048), (65_536, 2048),
                                 (12_345, 1024), (4097, 128), (4096, 2048)])
def test_segment_rule_matches_jax(small_segments, E, T):
    """(seg, n_seg) of the port's rule equal the JAX package's, each
    segment a T-multiple of at most MAX_REFS covering every ref."""
    jnp = pytest.importorskip("jax.numpy")
    jbf = small_segments
    seen = []

    def record(queries, refs, k, T_, G, S_out, seg_, n_seg, interpret):
        seen.append((seg_, n_seg))
        return None

    got_seg, got_n = tbf.segments(E, T)
    if E <= SMALL_MAX_REFS:
        assert (got_seg, got_n) == (E, 1)
        return
    jbf._binfold_segments, saved = record, jbf._binfold_segments
    try:
        jbf.knn_binfold(jnp.zeros((2, 3)), jnp.zeros((E, 3)), 4, T=T)
    finally:
        jbf._binfold_segments = saved
    assert seen == [(got_seg, got_n)]
    assert got_seg % T == 0 and got_seg <= SMALL_MAX_REFS
    assert (got_n - 1) * got_seg < E <= got_n * got_seg


@pytest.mark.fast
@pytest.mark.parametrize("rows,digits", [(10_000_000, (3, 7)),
                                         (30_000_000, (3, 8)),
                                         (100_000_000, (3, 8))])
def test_cluster_passes_at_scale_rows(rows, digits):
    """At 10M-100M rows over an H100's 7 clusters a cluster's range needs
    three radix passes; the modeled passes give the stable sort's order."""
    from test_torch_determinism import _cluster_radix_model

    groups, span = seg.cluster_rows(rows, 7)
    assert seg.radix_digits(span) == digits
    if rows == 10_000_000:
        assert span == 1_428_572
    rng = np.random.default_rng(rows % 1000)
    M = 3000
    ids = rng.integers(0, rows, M)
    ids[::3] = rng.integers(0, 5, len(ids[::3]))  # runs in cluster 0
    ids[1::7] = rows - 1 - rng.integers(0, 3, len(ids[1::7]))  # the last
    ids[2::11] = span * rng.integers(0, groups, len(ids[2::11]))  # edges
    row, term = _cluster_radix_model(ids, rows, groups=7)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(term, order)
    np.testing.assert_array_equal(row, ids[order])


def _same_csr(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.fast
@pytest.mark.parametrize("script,n,chords", [
    ("bench_1m_skewed", 5000, 15000),
    ("bench_10m", 4000, 10000),
    ("bench_30m", 3000, 6600),
    ("bench_100m", 10000, 1500),
])
def test_tier_graphs_match_the_jax_scripts(tmp_path, monkeypatch, script,
                                           n, chords):
    """Each tier's builder draws the JAX script's graph: the same CSR."""
    mod = _load(f"experiments/{script}.py", f"jax_{script}")
    monkeypatch.setattr(mod, "N", n)
    monkeypatch.setattr(mod, "CHORDS", chords)
    if hasattr(mod, "CACHE"):
        monkeypatch.setattr(mod, "CACHE", str(tmp_path / "graph.npz"))
    want = mod.build_adj()
    if script == "bench_1m_skewed":
        assert mod.ZIPF_A == tiers.ZIPF_A
        got = tiers.skewed_graph(n, chords)
    else:
        got = tiers.ring_graph(n, chords)
    _same_csr(got, want)


@pytest.mark.fast
def test_tier_table_and_graph_cache(tmp_path, monkeypatch):
    """The tiers are those of the JAX scripts, in order; a cached graph
    loads equal to the built one."""
    assert tiers.TIERS == ("skewed_1m", "ring_10m", "ring_10m_setup",
                           "ring_30m", "ring_100m")
    assert [tiers.TIER_SPECS[t][1:3] for t in tiers.TIERS] == [
        (1_000_000, 3_000_000), (10_000_000, 25_000_000),
        (10_000_000, 25_000_000), (30_000_000, 66_000_000),
        (100_000_000, 15_000_000)]
    monkeypatch.setattr(tiers, "CACHE", str(tmp_path))
    built, _, cached = tiers.graph("ring", 3000, 6000, cache=True)
    loaded, _, again = tiers.graph("ring", 3000, 6000, cache=True)
    assert (cached, again) == (False, True)
    _same_csr(loaded, built)
    reckoned = tiers.reckon_bytes(100_000_000, 115_000_000)
    # positions, tables and the step's peak at 100M: well under 80 GB
    assert 10 * 2**30 < reckoned["device_total"] < 80 * 2**30


@pytest.mark.fast
def test_tier_script_runs_on_the_cpu():
    """The script end to end at --shrink on the CPU: a build line, then
    one JSON line a tier, each in its own process, with the fields the
    records read; the same seed gives the same positions' bytes."""
    import json
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_scale_tiers.py"),
         "--tiers", "ring_100m,skewed_1m,ring_100m", "--shrink", "10000",
         "--device", "cpu", "--no-cache"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [json.loads(ln) for ln in res.stdout.splitlines()
            if ln.startswith("{")]
    assert rows[0]["build"] == ["fastgraph"]
    tiers_run = rows[1:]
    assert [r["tier"] for r in tiers_run] == ["ring_100m", "skewed_1m",
                                               "ring_100m"]
    for r in tiers_run:
        assert r["finite"] and r["n"] == tiers.TIER_SPECS[r["tier"]][1] // 10000
        assert np.allclose(r["std"], 1.0, atol=1e-3)
        for key in ("E", "table", "strategy", "ref_slots", "setup_s", "split",
                    "first_run_s", "ms_per_iter", "edges_per_s",
                    "host_peak_rss_gib", "spearman_radius_degree",
                    "reckoned"):
            assert key in r, key
    assert tiers_run[0]["positions_sha1"] == tiers_run[2]["positions_sha1"]
    assert "plan_longest_run" in tiers_run[1]  # the hubs' block plan
