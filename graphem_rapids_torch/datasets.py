"""Real-world dataset loaders.

Counterpart of ``graphem_rapids_tpu/datasets.py``: the same registries (SNAP,
the vendored classic graphs under benchmarks/data/vendored, Network
Repository, Semantic Scholar), ``load_dataset`` with its prefix routing, and
the same local cache (``GRAPHEM_DATA_DIR``, default ``data/`` at the repo
root): a loader reads its cached files and downloads only when they are
missing. Edge files are parsed by the C scanner of ``native/``, as the
JAX package parses them with its own (gzip files decompressed first), and
csv files with the standard library; ``download_file`` uses urllib.
networkx is imported only by the two functions that return a networkx
graph.
"""

import csv
import gzip
import logging
import os
import shutil
import tarfile
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from . import native as fg

logger = logging.getLogger(__name__)


def get_data_directory():
    """Dataset cache directory (env GRAPHEM_DATA_DIR overrides)."""
    env = os.environ.get("GRAPHEM_DATA_DIR")
    data_dir = Path(env) if env else Path(__file__).parent.parent / "data"
    data_dir.mkdir(exist_ok=True, parents=True)
    return data_dir


def download_file(url, filepath, description=None, timeout=60):
    """Streaming download of ``url`` to ``filepath`` (no-op if it exists),
    with a log line every 10% when the size is known."""
    filepath = Path(filepath)
    filepath.parent.mkdir(exist_ok=True, parents=True)
    if filepath.exists():
        logger.info("File already exists: %s", filepath)
        return
    logger.info("Downloading %s -> %s (%s)", url, filepath, description or "")
    tmp = filepath.with_name(filepath.name + ".part")
    with urllib.request.urlopen(url, timeout=timeout) as response, \
            open(tmp, "wb") as f:
        total = int(response.headers.get("Content-Length") or 0)
        done, next_pct = 0, 10
        while True:
            chunk = response.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
            done += len(chunk)
            if total and done * 100 >= next_pct * total:
                logger.info("  %s: %d%% (%.1f MB)", description or "download",
                            next_pct, done / 1e6)
                next_pct += 10
    tmp.replace(filepath)


def extract_file(filepath, extract_dir=None):
    """Extract .gz / .zip / .tar(.gz) archives into ``extract_dir``
    (default: the archive's directory)."""
    filepath = Path(filepath)
    extract_dir = Path(extract_dir) if extract_dir else filepath.parent
    extract_dir.mkdir(exist_ok=True, parents=True)
    logger.info("Extracting %s to %s", filepath, extract_dir)

    name = filepath.name
    if name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(filepath, "r:*") as tar_ref:
            tar_ref.extractall(extract_dir)
    elif name.endswith(".gz"):
        with gzip.open(filepath, "rb") as f_in:
            with open(extract_dir / filepath.stem, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
    elif name.endswith(".zip"):
        with zipfile.ZipFile(filepath, "r") as zip_ref:
            zip_ref.extractall(extract_dir)
    else:
        logger.warning("Unknown compression format: %s", filepath.suffix)
    return extract_dir


def _parse_edge_text(path, comment="#", one_based=False, skip_header=False):
    """Whitespace edge-list parser -> (E, 2) int64 array.

    Comment lines ('#' or '%', and ``comment``) and lines without two
    integers are skipped, the first two fields of each line are the edge,
    and ``skip_header`` drops the first data row (a Matrix Market size
    line). A '.gz' path is read through gzip. The bytes go to the C scanner
    (native.parse_edges_native), which knows only '#' and '%'; any other
    ``comment`` takes its plain version.
    """
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()
    if comment == "#":
        return fg.parse_edges_native(raw, one_based=one_based,
                                     skip_header=skip_header)
    return fg.parse_edges_plain(raw, one_based=one_based,
                                skip_header=skip_header, comment=comment)


def symmetrize_edges(edges):
    """Undirected canonical form: both directions, dedupe, keep i < j."""
    if len(edges) == 0:
        return edges.reshape(0, 2)
    all_edges = np.vstack([edges, edges[:, ::-1]])
    unique_edges = np.unique(all_edges, axis=0)
    return unique_edges[unique_edges[:, 0] < unique_edges[:, 1]]


class DatasetLoader:
    """Base class for dataset loaders."""

    def __init__(self, name):
        self.name = name
        self.data_dir = get_data_directory() / name

    def download(self):
        raise NotImplementedError

    def load(self):
        raise NotImplementedError

    def is_downloaded(self):
        raise NotImplementedError

    def load_as_networkx(self):
        """The dataset as a relabeled networkx graph (imports networkx)."""
        import networkx as nx

        vertices, edges = self.load()
        G = nx.Graph()
        G.add_nodes_from(vertices)
        G.add_edges_from(edges)
        return nx.convert_node_labels_to_integers(G, first_label=0)

    def info(self):
        if not self.is_downloaded():
            print(f"Dataset '{self.name}' is not downloaded yet.")
            return
        vertices, edges = self.load()
        print(f"Dataset: {self.name}")
        print(f"  vertices: {len(vertices)}")
        print(f"  edges: {len(edges)}")


class SNAPDataset(DatasetLoader):
    """Stanford SNAP datasets (https://snap.stanford.edu/data/)."""

    AVAILABLE_DATASETS = {
        "facebook_combined": {
            "url": "https://snap.stanford.edu/data/facebook_combined.txt.gz",
            "description": "Facebook social network",
            "directed": False, "nodes": 4039, "edges": 88234,
        },
        "ego-twitter": {
            "url": "https://snap.stanford.edu/data/twitter_combined.txt.gz",
            "description": "Twitter ego network",
            "directed": True, "nodes": 81306, "edges": 1768149,
        },
        "wiki-vote": {
            "url": "https://snap.stanford.edu/data/wiki-Vote.txt.gz",
            "description": "Wikipedia who-votes-on-whom network",
            "directed": True, "nodes": 7115, "edges": 103689,
        },
        "ca-GrQc": {
            "url": "https://snap.stanford.edu/data/ca-GrQc.txt.gz",
            "description": "Collaboration network of Arxiv General Relativity",
            "directed": False, "nodes": 5242, "edges": 14496,
        },
        "ca-HepTh": {
            "url": "https://snap.stanford.edu/data/ca-HepTh.txt.gz",
            "description": "Collaboration network of Arxiv HEP Theory",
            "directed": False, "nodes": 9877, "edges": 25998,
        },
        "oregon1_010331": {
            "url": "https://snap.stanford.edu/data/oregon1_010331.txt.gz",
            "description": "AS peering network from Oregon route views",
            "directed": False, "nodes": 10670, "edges": 22002,
        },
        "p2p-Gnutella04": {
            "url": "https://snap.stanford.edu/data/p2p-Gnutella04.txt.gz",
            "description": "Gnutella peer-to-peer network (2002-08-04)",
            "directed": True, "nodes": 10876, "edges": 39994,
        },
        "email-Enron": {
            "url": "https://snap.stanford.edu/data/email-Enron.txt.gz",
            "description": "Email communication network from Enron",
            "directed": True, "nodes": 36692, "edges": 183831,
        },
    }

    def __init__(self, dataset_name):
        if dataset_name not in self.AVAILABLE_DATASETS:
            raise ValueError(
                f"Unknown SNAP dataset: {dataset_name}. Available: "
                f"{', '.join(self.AVAILABLE_DATASETS)}"
            )
        self.dataset_info = self.AVAILABLE_DATASETS[dataset_name]
        super().__init__(f"snap-{dataset_name}")
        self.dataset_name = dataset_name
        self.url = self.dataset_info["url"]
        self.is_directed = self.dataset_info["directed"]

    def _edges_path(self):
        filename = self.url.split("/")[-1].replace(".gz", "")
        return self.data_dir / filename

    def is_downloaded(self):
        return self._edges_path().exists()

    def download(self):
        if self.is_downloaded():
            logger.info("Dataset %s already downloaded.", self.dataset_name)
            return
        filename = self.url.split("/")[-1]
        download_path = self.data_dir / filename
        download_file(self.url, download_path, self.dataset_name)
        extract_file(download_path, self.data_dir)

    def load(self):
        if not self.is_downloaded():
            self.download()
        edges = _parse_edge_text(self._edges_path())
        edges = symmetrize_edges(edges)
        vertices = np.unique(edges.flatten())
        return vertices, edges


class VendoredDataset(DatasetLoader):
    """Real graphs vendored into the repo (benchmarks/data/vendored).

    Classic recorded social networks in SNAP edge-list format, checked
    in, so the dataset pipeline (gz extraction, edge-text parsing,
    symmetrization) runs on real data with no network access; the SNAP
    and Network Repository tiers download.
    """

    AVAILABLE_DATASETS = {
        "karate": {
            "description": "Zachary's karate club social network (1977)",
            "directed": False, "nodes": 34, "edges": 78,
        },
        "lesmis": {
            "description": "Les Miserables co-appearance network "
                           "(Knuth 1993)",
            "directed": False, "nodes": 77, "edges": 254,
        },
        "florentine": {
            "description": "Florentine families marriage network "
                           "(Padgett 1994)",
            "directed": False, "nodes": 15, "edges": 20,
        },
        "davis": {
            "description": "Davis Southern Women attendance network "
                           "(1941)",
            "directed": False, "nodes": 32, "edges": 89,
        },
    }

    def __init__(self, dataset_name):
        if dataset_name not in self.AVAILABLE_DATASETS:
            raise ValueError(
                f"Unknown vendored dataset: {dataset_name}. Available: "
                f"{', '.join(self.AVAILABLE_DATASETS)}"
            )
        self.dataset_info = self.AVAILABLE_DATASETS[dataset_name]
        super().__init__(f"local-{dataset_name}")
        self.dataset_name = dataset_name

    def _gz_path(self):
        return (
            Path(__file__).resolve().parent.parent / "benchmarks" / "data"
            / "vendored" / f"{self.dataset_name}.txt.gz"
        )

    def is_downloaded(self):
        return self._gz_path().exists()

    def download(self):
        if not self.is_downloaded():
            raise FileNotFoundError(
                f"Vendored dataset file missing: {self._gz_path()} "
                f"(regenerate with scripts/vendor_datasets.py)"
            )

    def load(self):
        self.download()
        self.data_dir.mkdir(parents=True, exist_ok=True)
        extracted = self.data_dir / f"{self.dataset_name}.txt"
        if not extracted.exists():
            with gzip.open(self._gz_path(), "rb") as src, \
                    open(extracted, "wb") as dst:
                shutil.copyfileobj(src, dst)
        edges = _parse_edge_text(extracted)
        edges = symmetrize_edges(edges)
        vertices = np.unique(edges.flatten())
        return vertices, edges


class NetworkRepositoryDataset(DatasetLoader):
    """Network Repository datasets (https://networkrepository.com/)."""

    AVAILABLE_DATASETS = {
        "soc-hamsterster": {
            "url": "https://nrvis.com/download/data/soc/soc-hamsterster.zip",
            "description": "Hamsterster social network",
            "directed": False, "file_pattern": "soc-hamsterster.mtx",
        },
        "socfb-MIT": {
            "url": "https://nrvis.com/download/data/socfb/socfb-MIT.zip",
            "description": "Facebook network from MIT",
            "directed": False, "file_pattern": "socfb-MIT.mtx",
        },
        "ca-cit-HepPh": {
            "url": "https://nrvis.com/download/data/ca/ca-cit-HepPh.zip",
            "description": "Citation network of Arxiv High Energy Physics",
            "directed": True, "file_pattern": "ca-cit-HepPh.mtx",
        },
        "web-google-dir": {
            "url": "https://nrvis.com/download/data/web/web-google-dir.zip",
            "description": "Google web graph",
            "directed": True, "file_pattern": "web-google-dir.edges",
        },
        "ia-reality": {
            "url": "https://nrvis.com/download/data/ia/ia-reality.zip",
            "description": "Reality Mining social network",
            "directed": False, "file_pattern": "ia-reality.mtx",
        },
    }

    def __init__(self, dataset_name):
        if dataset_name not in self.AVAILABLE_DATASETS:
            raise ValueError(
                f"Unknown Network Repository dataset: {dataset_name}. "
                f"Available: {', '.join(self.AVAILABLE_DATASETS)}"
            )
        self.dataset_info = self.AVAILABLE_DATASETS[dataset_name]
        super().__init__(f"netrepo-{dataset_name}")
        self.dataset_name = dataset_name
        self.url = self.dataset_info["url"]
        self.is_directed = self.dataset_info["directed"]
        self.file_pattern = self.dataset_info["file_pattern"]

    def _find_data_file(self):
        path = self.data_dir / self.file_pattern
        if path.exists():
            return path
        matches = list(self.data_dir.glob("*.mtx")) + list(
            self.data_dir.glob("*.edges")
        )
        return matches[0] if matches else None

    def is_downloaded(self):
        return self._find_data_file() is not None

    def download(self):
        if self.is_downloaded():
            logger.info("Dataset %s already downloaded.", self.dataset_name)
            return
        filename = self.url.split("/")[-1]
        download_path = self.data_dir / filename
        download_file(self.url, download_path, self.dataset_name)
        extract_file(download_path, self.data_dir)

    def load(self):
        if not self.is_downloaded():
            self.download()
        path = self._find_data_file()
        if path.suffix == ".mtx":
            # Matrix Market: 1-based indices, first non-comment row is dims.
            edges = _parse_edge_text(path, one_based=True, skip_header=True)
        else:
            edges = _parse_edge_text(path)
        # directed sources are symmetrized too: the engine consumes
        # undirected i<j edge lists 
        edges = symmetrize_edges(edges)
        vertices = np.unique(edges.flatten())
        return vertices, edges


class SemanticScholarDataset(DatasetLoader):
    """Semantic Scholar citation networks."""

    AVAILABLE_DATASETS = {
        "s2-CS": {
            "url": "https://github.com/mattbierbaum/citation-networks/raw/"
                   "master/s2-CS.tar.gz",
            "description": "Computer Science citation network",
            "nodes_file": "s2-CS-nodes.csv",
            "edges_file": "s2-CS-citations.csv",
        },
    }

    def __init__(self, dataset_name="s2-CS"):
        if dataset_name not in self.AVAILABLE_DATASETS:
            raise ValueError(
                f"Unknown Semantic Scholar dataset: {dataset_name}. "
                f"Available: {', '.join(self.AVAILABLE_DATASETS)}"
            )
        self.dataset_info = self.AVAILABLE_DATASETS[dataset_name]
        super().__init__(f"semanticscholar-{dataset_name}")
        self.dataset_name = dataset_name
        self.url = self.dataset_info["url"]
        self.nodes_file = self.dataset_info["nodes_file"]
        self.edges_file = self.dataset_info["edges_file"]

    def is_downloaded(self):
        return (self.data_dir / self.nodes_file).exists() and (
            self.data_dir / self.edges_file
        ).exists()

    def download(self):
        if self.is_downloaded():
            logger.info("Dataset %s already downloaded.", self.dataset_name)
            return
        filename = self.url.split("/")[-1]
        download_path = self.data_dir / filename
        download_file(self.url, download_path, self.dataset_name)
        extract_file(download_path, self.data_dir)

    def load(self):
        if not self.is_downloaded():
            self.download()
        with open(self.data_dir / self.nodes_file, newline="") as f:
            idx = {row["id"]: i for i, row in enumerate(csv.DictReader(f))}
        with open(self.data_dir / self.edges_file, newline="") as f:
            pairs = [(idx.get(row["source"]), idx.get(row["target"]))
                     for row in csv.DictReader(f)]
        # citations whose ends are both listed nodes
        edges = np.array([p for p in pairs if None not in p],
                         np.int64).reshape(-1, 2)
        edges = symmetrize_edges(edges)
        vertices = np.unique(edges.flatten())
        return vertices, edges


def list_available_datasets():
    """All registered datasets across sources."""
    all_datasets = {}
    for name, info in SNAPDataset.AVAILABLE_DATASETS.items():
        all_datasets[f"snap-{name}"] = {
            "source": "SNAP", "name": name,
            "description": info["description"],
            "nodes": info.get("nodes", "Unknown"),
            "edges": info.get("edges", "Unknown"),
            "directed": info["directed"],
        }
    for name, info in VendoredDataset.AVAILABLE_DATASETS.items():
        all_datasets[f"local-{name}"] = {
            "source": "vendored (real graph, in-repo)", "name": name,
            "description": info["description"],
            "nodes": info.get("nodes", "Unknown"),
            "edges": info.get("edges", "Unknown"),
            "directed": info["directed"],
        }
    for name, info in NetworkRepositoryDataset.AVAILABLE_DATASETS.items():
        all_datasets[f"netrepo-{name}"] = {
            "source": "Network Repository", "name": name,
            "description": info["description"],
            "directed": info["directed"],
        }
    for name, info in SemanticScholarDataset.AVAILABLE_DATASETS.items():
        all_datasets[f"semanticscholar-{name}"] = {
            "source": "Semantic Scholar", "name": name,
            "description": info["description"],
        }
    return all_datasets


def load_dataset(dataset_name):
    """Load a dataset by prefixed or bare name -> (vertices, edges)."""
    loader = None
    if dataset_name.startswith("snap-"):
        loader = SNAPDataset(dataset_name[5:])
    elif dataset_name.startswith("local-"):
        loader = VendoredDataset(dataset_name[6:])
    elif dataset_name.startswith("netrepo-"):
        loader = NetworkRepositoryDataset(dataset_name[8:])
    elif dataset_name.startswith("semanticscholar-"):
        loader = SemanticScholarDataset(dataset_name[16:])
    elif dataset_name in SNAPDataset.AVAILABLE_DATASETS:
        loader = SNAPDataset(dataset_name)
    elif dataset_name in VendoredDataset.AVAILABLE_DATASETS:
        loader = VendoredDataset(dataset_name)
    elif dataset_name in NetworkRepositoryDataset.AVAILABLE_DATASETS:
        loader = NetworkRepositoryDataset(dataset_name)
    elif dataset_name in SemanticScholarDataset.AVAILABLE_DATASETS:
        loader = SemanticScholarDataset(dataset_name)
    if loader is None:
        raise ValueError(f"Unknown dataset: {dataset_name}")
    return loader.load()


def load_dataset_as_networkx(dataset_name):
    """Load a dataset as a relabeled NetworkX graph (imports networkx,
    which the port does not otherwise need)."""
    import networkx as nx

    vertices, edges = load_dataset(dataset_name)
    G = nx.Graph()
    G.add_nodes_from(vertices)
    G.add_edges_from(edges)
    return nx.convert_node_labels_to_integers(G, first_label=0)


def load_dataset_as_adjacency(dataset_name):
    """Load a dataset directly as a sparse CSR adjacency (compact labels),
    ready for GraphEmbedderTorch / create_graphem."""
    vertices, edges = load_dataset(dataset_name)
    if len(edges) == 0:
        raise ValueError(
            f"Dataset {dataset_name!r} parsed to zero edges — the cached "
            f"file may be empty or corrupt (cache dir: {get_data_directory()})"
        )
    remap = -np.ones(int(vertices.max()) + 1, np.int64)
    remap[vertices] = np.arange(len(vertices))
    edges = remap[edges]
    n = len(vertices)
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    adj = sp.csr_matrix(
        (np.ones(len(rows), np.int64), (rows, cols)), shape=(n, n)
    )
    adj.data[:] = 1
    return adj
