"""The port's reports and plots against the JAX package's
(tests/test_visualization.py and the report cases of
tests/test_integration.py). The statistics need only scipy and equal JAX's;
pandas and plotly are imported only when a table or a plot is asked for, and
their absence raises a clean ImportError.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import graphem_rapids_tpu as gr
import graphem_rapids_torch as grt
from graphem_rapids_tpu import visualization as jviz
from graphem_rapids_torch import visualization as viz


def _has_plotly():
    try:
        import plotly  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.fast
def test_report_corr_values(capsys):
    rng = np.random.default_rng(0)
    x = rng.random(200)
    rho, p = grt.report_corr("self", x, x, reps=20, seed=0)
    assert rho == pytest.approx(1.0)
    rho2, _ = grt.report_corr("anti", x, -x, reps=20, seed=0)
    assert rho2 == pytest.approx(-1.0)


@pytest.mark.fast
def test_report_corr_equals_jax(capsys):
    """Same Spearman rho, p and bootstrap interval (the printed line)."""
    rng = np.random.default_rng(1)
    radii = rng.random(150)
    deg = radii + rng.random(150) * 0.5
    got = grt.report_corr("degree", radii, deg, reps=50, seed=3)
    got_out = capsys.readouterr().out
    want = gr.report_corr("degree", radii, deg, reps=50, seed=3)
    assert got == want
    assert got_out == capsys.readouterr().out


@pytest.mark.fast
def test_report_corr_handles_noise():
    rng = np.random.default_rng(0)
    rho, p = grt.report_corr("noise", rng.random(200), rng.random(200),
                             reps=20, seed=0)
    assert abs(rho) < 0.3


@pytest.mark.fast
def test_full_correlation_matrix_equals_jax(capsys):
    rng = np.random.default_rng(0)
    radii = rng.random(100)
    deg = radii * 2 + rng.random(100) * 0.1
    cols = [rng.random(100) for _ in range(5)]
    got = grt.report_full_correlation_matrix(radii, deg, *cols)
    want = gr.report_full_correlation_matrix(radii, deg, *cols)
    assert got.shape == (7, 7)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.fast
def test_plot_functions_gated_without_plotly():
    if _has_plotly():
        pytest.skip("plotly installed; gating not exercised")
    with pytest.raises(ImportError, match="plotly"):
        grt.plot_radial_vs_centrality(np.ones(3), [np.ones(3)], ["x"])
    with pytest.raises(ImportError, match="plotly"):
        viz.plot_layout(np.zeros((3, 2)), np.array([[0, 1]]))
    emb = grt.GraphEmbedderTorch(sp.csr_matrix(np.ones((4, 4)) - np.eye(4)),
                                 device="cpu", verbose=False, seed=0)
    with pytest.raises(ImportError, match="plotly"):
        emb.display_layout()


@pytest.mark.fast
def test_tables_gated_without_pandas(monkeypatch):
    """With pandas missing the table functions raise a clean ImportError,
    and the statistics still work."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas is required"):
        grt.display_benchmark_results([{"n": 1}])
    with pytest.raises(ImportError, match="pandas is required"):
        grt.report_full_correlation_matrix(*[np.arange(5.0)] * 7)
    rho, _ = grt.report_corr("x", np.arange(10.0), np.arange(10.0), reps=5,
                             seed=0)
    assert rho == pytest.approx(1.0)


@pytest.mark.fast
def test_plot_layout_dim_validation():
    if _has_plotly():
        with pytest.raises(ValueError, match="2D or 3D"):
            viz.plot_layout(np.zeros((3, 5)), np.array([[0, 1]]))
    else:
        with pytest.raises(ImportError):
            viz.plot_layout(np.zeros((3, 5)), np.array([[0, 1]]))


@pytest.mark.fast
@pytest.mark.parametrize("d,E", [(2, 2), (3, 50), (2, 0)])
def test_edge_polyline_coords_equal_jax(d, E):
    rng = np.random.default_rng(d + E)
    pos = rng.standard_normal((20, d))
    edges = rng.integers(0, 20, (E, 2))
    np.testing.assert_array_equal(viz._edge_polyline_coords(pos, edges, d),
                                  jviz._edge_polyline_coords(pos, edges, d))


@pytest.mark.fast
def test_edge_polyline_coords_values():
    pos = np.array([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]])
    edges = np.array([[0, 1], [1, 2]])
    coords = viz._edge_polyline_coords(pos, edges, 2)
    assert coords.shape == (3, 6)
    np.testing.assert_allclose(coords[0][[0, 1, 3, 4]], [0, 2, 2, 4])
    np.testing.assert_allclose(coords[1][[0, 1, 3, 4]], [1, 3, 3, 5])
    assert np.isnan(coords[0][[2, 5]]).all()
    assert np.isnan(coords[2]).all()


@pytest.mark.fast
def test_edge_polyline_coords_1m_edges_fast():
    """The polyline build is vectorized: 1M edges well under a second
    unloaded (the bound leaves headroom for a loaded host)."""
    import time

    rng = np.random.default_rng(0)
    pos = rng.standard_normal((100_000, 3))
    edges = rng.integers(0, 100_000, size=(1_000_000, 2))
    t0 = time.perf_counter()
    coords = viz._edge_polyline_coords(pos, edges, 3)
    dt = time.perf_counter() - t0
    assert coords.shape == (3, 3_000_000)
    assert dt < 5.0, f"polyline build took {dt:.2f}s"


@pytest.mark.fast
@pytest.mark.parametrize("rows", [
    [{"m": 1, "n": 2, "graph_type": "g", "extra": 9}],
    [{"graph_type": "er", "n": 10, "m": 20, "layout_time": 0.5}],
])
def test_display_benchmark_results_equals_jax(rows):
    got = grt.display_benchmark_results(rows)
    assert list(got.columns)[:3] == ["graph_type", "n", "m"]
    pd.testing.assert_frame_equal(got, gr.display_benchmark_results(rows))
