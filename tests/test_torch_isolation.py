"""The PyTorch port stands alone: no JAX, no JAX package, no networkx/pandas.

The card's machine has PyTorch but no JAX, networkx, pandas, plotly or
ndlib, so neither graphem_rapids_torch nor chip_smoke.py nor
scripts/torch_scale_tiers.py may import them or the JAX package's
experiments, directly or through the JAX package. The optional packages are imported only
inside the LAZY_IMPORTS functions, when they are called, so the import-time
check forbids them and the source scan allows them only there.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import scipy.sparse as sp
import torch

from graphem_rapids_torch import GraphEmbedderTorch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "graphem_rapids_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "torch_scale_tiers.py"
]
FORBIDDEN = ("jax", "jaxlib", "graphem_rapids_tpu", "experiments", "networkx",
             "pandas", "plotly", "ndlib")

_spec = importlib.util.spec_from_file_location(
    "lintmod", REPO / "scripts" / "lint.py"
)
lintmod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lintmod)


# the functions allowed to import optional packages, and which: each
# imports them when called, never when its module is imported
LAZY_IMPORTS = {
    "ndlib_estimated_influence": ("ndlib", "networkx"),
    "_pandas": ("pandas",),
    "_plotly": ("plotly",),
    "load_as_networkx": ("networkx",),
    "load_dataset_as_networkx": ("networkx",),
    "compute_centralities": ("networkx",),
    "_adjacency_to_nx": ("networkx",),
}


def _lazy_import_nodes(tree):
    """The import statements inside LAZY_IMPORTS functions that import only
    the packages those functions are allowed."""
    nodes = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in LAZY_IMPORTS:
            for node in ast.walk(fn):
                if isinstance(node, ast.Import) and all(
                        a.name.split(".")[0] in LAZY_IMPORTS[fn.name]
                        for a in node.names):
                    nodes.add(id(node))
    return nodes


def _imported_modules(path):
    """Every module a file imports, including import_module("...") calls,
    except the lazy imports of LAZY_IMPORTS."""
    tree = ast.parse(path.read_text(), filename=str(path))
    lazy = _lazy_import_nodes(tree)
    names = []
    for node in ast.walk(tree):
        if id(node) in lazy:
            continue
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


@pytest.mark.fast
def test_import_pulls_in_no_jax():
    code = (
        "import sys, graphem_rapids_torch, graphem_rapids_torch.ops.knn, "
        "graphem_rapids_torch.ops.laplacian, graphem_rapids_torch.convert, "
        "graphem_rapids_torch.influence, graphem_rapids_torch.ops.ic_sim, "
        "graphem_rapids_torch.ops.ic_cascade, "
        "graphem_rapids_torch.ops.knn_pallas, graphem_rapids_torch.utils, "
        "graphem_rapids_torch.utils.backend_selection, "
        "graphem_rapids_torch.utils.memory_management, "
        "graphem_rapids_torch.utils.profiling, "
        "graphem_rapids_torch.parallel.ring_binfold, "
        "graphem_rapids_torch.parallel.sharded_step, "
        "graphem_rapids_torch.generators, graphem_rapids_torch.datasets, "
        "graphem_rapids_torch.visualization, graphem_rapids_torch.benchmark, "
        "graphem_rapids_torch.native, graphem_rapids_torch.models.oracle, "
        "graphem_rapids_torch.ops\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.fast
@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.fast
def test_port_is_lint_clean(monkeypatch):
    monkeypatch.chdir(REPO)
    assert lintmod.main(["graphem_rapids_torch", "chip_smoke.py",
                         "scripts/torch_scale_tiers.py"]) == 0


@pytest.mark.fast
def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adj = sp.csr_matrix(([1, 1], ([0, 1], [1, 0])), shape=(3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEmbedderTorch(adj, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphEmbedderTorch(adj, device="cuda", verbose=False)


@pytest.mark.fast
def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: chip_smoke.py exits nonzero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
