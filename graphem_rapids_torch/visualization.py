"""Visualization and reporting utilities.

Counterpart of ``graphem_rapids_tpu/visualization.py``. The statistics
(Spearman correlations with bootstrap intervals) need only scipy. pandas
(tables) and plotly (plots) are optional, and imported by the functions
that use them, when they are called: without them those functions raise a
clean ImportError, and with them they return what the JAX package's return.
"""

import numpy as np
from scipy import stats


def _pandas():
    """The pandas module, or a clean ImportError."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            "pandas is required for result tables; install pandas or use "
            "the statistics function report_corr."
        ) from e
    return pd


def _plotly():
    """(plotly.express, plotly.graph_objects), or a clean ImportError."""
    try:
        import plotly.express as px
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is required for interactive plots; install plotly or use "
            "the statistics functions (report_corr, "
            "report_full_correlation_matrix, display_benchmark_results)."
        ) from e
    return px, go


def report_corr(name, radii, centrality, alpha=0.025, reps=1000, seed=None):
    """Spearman rho of radii vs a centrality, with a bootstrap interval
    of ``reps`` resamples.

    Returns (rho, p_value).
    """
    radii = np.asarray(radii)
    centrality = np.asarray(centrality)
    rho, p_value = stats.spearmanr(radii, centrality)

    rng = np.random.default_rng(seed)
    n = len(radii)
    boot = np.empty(reps)
    for i in range(reps):
        idx = rng.integers(0, n, n)
        boot[i], _ = stats.spearmanr(radii[idx], centrality[idx])
    ci_low = np.nanpercentile(boot, 100 * alpha)
    ci_high = np.nanpercentile(boot, 100 * (1 - alpha))

    print(
        f"{name:15s}: rho = {rho:.3f} "
        f"(95% CI: [{ci_low:.3f}, {ci_high:.3f}]), p = {p_value:.6f}"
    )
    return rho, p_value


def report_full_correlation_matrix(radii, deg, btw, eig, pr, clo, nload,
                                   alpha=0.025):
    """Spearman correlation matrix (a pandas DataFrame) of radius vs six
    centralities, and each one's report_corr line. Requires pandas."""
    pd = _pandas()

    df = pd.DataFrame(
        {
            "Radius": radii,
            "Degree": deg,
            "Betweenness": btw,
            "Eigenvector": eig,
            "PageRank": pr,
            "Closeness": clo,
            "Node Load": nload,
        }
    )
    corr_matrix = df.corr(method="spearman")

    print("Correlations with radial distance:")
    report_corr("Degree", np.asarray(radii), np.asarray(deg), alpha)
    report_corr("Betweenness", np.asarray(radii), np.asarray(btw), alpha)
    report_corr("Eigenvector", np.asarray(radii), np.asarray(eig), alpha)
    report_corr("PageRank", np.asarray(radii), np.asarray(pr), alpha)
    report_corr("Closeness", np.asarray(radii), np.asarray(clo), alpha)
    report_corr("Node Load", np.asarray(radii), np.asarray(nload), alpha)
    return corr_matrix


def plot_radial_vs_centrality(radii, centralities, names):
    """Faceted scatter of radius vs centralities with OLS trendlines.
    Requires plotly (and pandas)."""
    px, _ = _plotly()
    pd = _pandas()

    fig = px.scatter(
        pd.DataFrame(
            {
                "Radial Distance": np.tile(radii, len(names)),
                "Centrality Value": np.concatenate(centralities),
                "Centrality Measure": np.repeat(names, len(radii)),
            }
        ),
        x="Radial Distance",
        y="Centrality Value",
        facet_col="Centrality Measure",
        facet_col_wrap=3,
        trendline="ols",
        title="Correlation between Radial Distance and Centrality Measures",
    )
    fig.update_layout(height=800, width=1000)
    fig.show()


def _edge_polyline_coords(positions, edges, d):
    """Edge-polyline coordinates for plot_layout: a (3, 3E) array of
    per-axis [p_i, p_j, NaN] triples (plotly breaks a line at NaN), built by
    one gather per axis."""
    edges = np.asarray(edges)
    E = len(edges)
    coords = np.full((3, 3 * E), np.nan)
    if E:
        for axis in range(d):
            block = np.empty((E, 3))
            block[:, 0] = positions[edges[:, 0], axis]
            block[:, 1] = positions[edges[:, 1], axis]
            block[:, 2] = np.nan
            coords[axis] = block.ravel()
    return coords


def plot_layout(positions, edges, edge_width=1, node_size=3,
                node_colors=None):
    """2D/3D scatter of an embedding with its edges. Requires plotly."""
    _, go = _plotly()
    positions = np.asarray(positions)
    d = positions.shape[1]
    if d not in (2, 3):
        raise ValueError("Can only display 2D or 3D layouts")

    coords = _edge_polyline_coords(positions, edges, d)

    marker = {
        "color": node_colors if node_colors is not None else "red",
        "colorscale": "Bluered",
        "size": node_size,
        "colorbar": {"title": "Node Label"},
        "showscale": node_colors is not None,
    }
    if d == 2:
        traces = [
            go.Scatter(x=coords[0], y=coords[1], mode="lines",
                       line={"color": "gray", "width": edge_width},
                       hoverinfo="none"),
            go.Scatter(x=positions[:, 0], y=positions[:, 1], mode="markers",
                       marker=marker, hoverinfo="none"),
        ]
    else:
        traces = [
            go.Scatter3d(x=coords[0], y=coords[1], z=coords[2], mode="lines",
                         line={"color": "gray", "width": edge_width},
                         hoverinfo="none"),
            go.Scatter3d(x=positions[:, 0], y=positions[:, 1],
                         z=positions[:, 2], mode="markers", marker=marker,
                         hoverinfo="none"),
        ]
    fig = go.Figure(data=traces)
    fig.update_layout(
        title=f"{d}D Graph Embedding", showlegend=False,
        width=800, height=800,
    )
    fig.show()


def display_benchmark_results(benchmark_results):
    """Benchmark results as a tidy pandas DataFrame, in a fixed column
    order. Requires pandas."""
    pd = _pandas()

    df = pd.DataFrame(benchmark_results)
    columns = [
        "graph_type", "n", "m", "dim", "seed_method",
        "influence", "normalized_influence", "time",
        "layout_time", "selection_time", "evaluation_time",
    ]
    return df[[c for c in columns if c in df.columns]]
