"""The port's dataset loaders against the JAX package's
(tests/test_datasets.py): the same registries, the same parses of the same
local files, the same adjacencies from the vendored graphs. Downloads never
run. Each test that loads through the cache points GRAPHEM_DATA_DIR at its
own tmp_path.
"""

import gzip

import numpy as np
import pytest

import graphem_rapids_tpu.datasets as jds
import graphem_rapids_torch as grt
from graphem_rapids_torch.datasets import (
    NetworkRepositoryDataset,
    SemanticScholarDataset,
    SNAPDataset,
    VendoredDataset,
    _parse_edge_text,
    extract_file,
    list_available_datasets,
    load_dataset,
    load_dataset_as_adjacency,
    symmetrize_edges,
)

VENDORED = {"karate": (34, 78), "lesmis": (77, 254), "florentine": (15, 20),
            "davis": (32, 89)}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPHEM_DATA_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.fast
def test_registry_contents():
    datasets = list_available_datasets()
    assert datasets == jds.list_available_datasets()
    assert len([k for k in datasets if k.startswith("snap-")]) == 8
    assert len([k for k in datasets if k.startswith("netrepo-")]) == 5
    assert "snap-facebook_combined" in datasets
    assert "netrepo-soc-hamsterster" in datasets
    assert "semanticscholar-s2-CS" in datasets


@pytest.mark.fast
def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="Unknown dataset"):
        load_dataset("no-such-dataset")
    with pytest.raises(ValueError, match="Unknown SNAP"):
        SNAPDataset("no-such")
    with pytest.raises(ValueError, match="Unknown Network Repository"):
        NetworkRepositoryDataset("no-such")
    with pytest.raises(ValueError, match="Unknown Semantic Scholar"):
        SemanticScholarDataset("no-such")


PARSE_CASES = {
    "comments_blank_extra": ("edges.txt", "# comment\n0 1\n1 2\n\n2 3 extra\n",
                             {}),
    "tabs_and_percent": ("edges.txt", "% c\n5\t6\n  7   8  \n", {}),
    "mtx": ("graph.mtx", "%%MatrixMarket matrix coordinate\n% comment\n"
            "4 4 3\n1 2\n2 3\n3 4\n", {"one_based": True,
                                      "skip_header": True}),
    "empty": ("edges.txt", "# nothing\n\n", {}),
}


@pytest.mark.fast
@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_edge_text_equals_jax(tmp_path, case):
    name, text, kw = PARSE_CASES[case]
    f = tmp_path / name
    f.write_text(text)
    got, want = _parse_edge_text(f, **kw), jds._parse_edge_text(f, **kw)
    assert got.dtype == np.int64 and got.shape == (len(want), 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.fast
def test_parse_edge_text(tmp_path):
    f = tmp_path / "edges.txt"
    f.write_text("# comment\n0 1\n1 2\n\n2 3 extra\n")
    assert _parse_edge_text(f).tolist() == [[0, 1], [1, 2], [2, 3]]
    gz = tmp_path / "edges.txt.gz"
    with gzip.open(gz, "wb") as out:
        out.write(b"0 1\n1 2\n")
    assert _parse_edge_text(gz).tolist() == [[0, 1], [1, 2]]


@pytest.mark.fast
def test_parse_mtx_style(tmp_path):
    f = tmp_path / "graph.mtx"
    f.write_text("%%MatrixMarket matrix coordinate\n% comment\n4 4 3\n"
                 "1 2\n2 3\n3 4\n")
    edges = _parse_edge_text(f, one_based=True, skip_header=True)
    assert edges.tolist() == [[0, 1], [1, 2], [2, 3]]


@pytest.mark.fast
def test_symmetrize_edges():
    edges = np.array([[1, 0], [0, 1], [2, 1], [3, 3]])
    sym = symmetrize_edges(edges)
    assert sym.tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(sym, jds.symmetrize_edges(edges))
    assert symmetrize_edges(np.zeros((0, 2), np.int64)).shape == (0, 2)


@pytest.mark.fast
def test_snap_loader_with_local_cache(cache):
    """Full load path against a fabricated local cache: no network."""
    d = cache / "snap-ca-GrQc"
    d.mkdir()
    (d / "ca-GrQc.txt").write_text("# FromNodeId ToNodeId\n0 1\n1 0\n1 2\n")
    vertices, edges = load_dataset("snap-ca-GrQc")
    assert edges.tolist() == [[0, 1], [1, 2]]
    assert vertices.tolist() == [0, 1, 2]


@pytest.mark.fast
def test_load_dataset_as_adjacency(cache):
    d = cache / "snap-ca-GrQc"
    d.mkdir()
    (d / "ca-GrQc.txt").write_text("5 10\n10 20\n")  # gaps get compacted
    adj = load_dataset_as_adjacency("snap-ca-GrQc")
    assert adj.shape == (3, 3)
    assert adj.nnz == 4
    assert (adj != jds.load_dataset_as_adjacency("snap-ca-GrQc")).nnz == 0


@pytest.mark.fast
def test_bare_name_routing(cache):
    d = cache / "snap-facebook_combined"
    d.mkdir()
    (d / "facebook_combined.txt").write_text("0 1\n")
    vertices, edges = load_dataset("facebook_combined")
    assert len(edges) == 1


@pytest.mark.fast
def test_netrepo_mtx_loading(cache):
    d = cache / "netrepo-ia-reality"
    d.mkdir()
    (d / "ia-reality.mtx").write_text("%%MatrixMarket\n3 3 2\n1 2\n2 3\n")
    vertices, edges = load_dataset("netrepo-ia-reality")
    assert edges.tolist() == [[0, 1], [1, 2]]


@pytest.mark.fast
def test_semantic_scholar_loading(cache):
    """The csv loader (the JAX one reads it with pandas) on a fabricated
    cache: ids map to row order, citations to unlisted ids are dropped."""
    d = cache / "semanticscholar-s2-CS"
    d.mkdir()
    (d / "s2-CS-nodes.csv").write_text("id,title\nb7,x\na1,y\nc3,z\n")
    (d / "s2-CS-citations.csv").write_text(
        "source,target\na1,b7\nc3,a1\nzz,a1\nb7,a1\n")
    vertices, edges = load_dataset("semanticscholar-s2-CS")
    want_v, want_e = jds.load_dataset("semanticscholar-s2-CS")
    assert edges.tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(edges, want_e)
    np.testing.assert_array_equal(vertices, want_v)


@pytest.mark.fast
def test_gz_extraction(tmp_path):
    src = tmp_path / "edges.txt.gz"
    with gzip.open(src, "wb") as f:
        f.write(b"0 1\n")
    extract_file(src)
    assert (tmp_path / "edges.txt").read_text() == "0 1\n"


@pytest.mark.fast
@pytest.mark.parametrize("name", list(VENDORED))
def test_vendored_datasets_load_end_to_end(cache, name):
    """The local-* tier loads through the full pipeline (gz extraction into
    the cache, parsing, symmetrization) with no network, to JAX's graph."""
    n, m = VENDORED[name]
    v, e = load_dataset(f"local-{name}")
    assert len(v) == n and len(e) == m
    assert (cache / f"local-{name}" / f"{name}.txt").exists()
    adj = load_dataset_as_adjacency(f"local-{name}")
    assert adj.shape == (n, n) and adj.nnz == 2 * m
    assert (adj != jds.load_dataset_as_adjacency(f"local-{name}")).nnz == 0
    assert f"local-{name}" in list_available_datasets()
    assert len(load_dataset(name)[1]) == m  # bare names route too


@pytest.mark.fast
def test_vendored_unknown_raises():
    with pytest.raises(ValueError, match="Unknown vendored"):
        VendoredDataset("nope")


@pytest.mark.fast
def test_load_as_networkx_matches_jax(cache):
    """networkx is imported inside the function only; the graph equals
    the JAX package's."""
    got = grt.load_dataset_as_networkx("local-florentine")
    want = jds.load_dataset_as_networkx("local-florentine")
    assert sorted(got.edges()) == sorted(want.edges())
    loader = VendoredDataset("davis")
    assert sorted(loader.load_as_networkx().edges()) == sorted(
        jds.VendoredDataset("davis").load_as_networkx().edges())


@pytest.mark.fast
def test_vendored_dataset_embeds(cache):
    """A vendored real graph drives the embedder end to end and radius
    correlates with degree (karate's hubs are its instructors)."""
    from scipy.stats import spearmanr

    adj = grt.load_dataset_as_adjacency("local-karate")
    emb = grt.create_graphem(adj, n_components=2, seed=0, verbose=False,
                             device="cpu")
    pos = emb.run_layout(num_iterations=30)
    assert np.isfinite(pos).all()
    deg = np.asarray(adj.sum(axis=1)).ravel()
    rho = spearmanr(np.linalg.norm(pos, axis=1), deg).statistic
    assert rho > 0.4, rho
