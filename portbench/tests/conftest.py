"""Shared set-up of the benchmark's CPU tests: a checkout-like root in a
temporary directory whose BENCHMARK.json names tiny copies of the cells'
configurations and mixes, so that a whole run fits a test on the CPU.

    python -m pytest portbench/tests          # from the repository root
"""

import inspect
import io
import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a CPU's size of graph, and the cut of each mix key where a mix has it
TINY_VERTICES = 3000
TINY_MIX = {"num_iterations": 2, "traced_calls": 1, "check_steps": 2,
            "check_calls": 2}


def tiny_config(cfg):
    """``cfg`` cut to a CPU's size: at most TINY_VERTICES vertices with the
    chords in the same ratio, the start that ``auto`` takes at the full
    size, and the bin-fold kNN forced, as a card's 'auto' takes it at the
    real sizes."""
    graph = cfg["graph"]
    n = graph["vertices"]
    vertices = min(n, TINY_VERTICES)
    graph.update(vertices=vertices,
                 chords=round(vertices * graph["chords"] / n))
    engine = cfg.get("engine")
    if engine is None:
        return cfg
    if engine.get("init") == "auto":
        from graphem_rapids_torch.ops.laplacian import spectral_init

        # the port's own threshold, from which 'auto' is the Chebyshev
        threshold = inspect.signature(spectral_init).parameters[
            "device_threshold"].default
        if n >= threshold:
            engine["init"] = "chebyshev"
    engine["backend"] = "binfold"
    return cfg


def tiny_mix(mix):
    """``mix`` with each of TINY_MIX's keys that it has cut."""
    mix.update({k: min(mix[k], v) for k, v in TINY_MIX.items() if k in mix})
    return mix


def cells(kind=None):
    """The names of the repository's cells, of one mix ``kind`` where given,
    read from BENCHMARK.json when the tests are collected."""
    from portbench.harness import registry

    bench = registry.load_benchmark(REPO)
    return [w["name"] for w in bench["workloads"]
            if kind is None
            or registry.mix(REPO, bench, w["traffic"])["kind"] == kind]


def make_root(base, source=REPO):
    """(root, bench): a checkout-like directory under ``base`` that holds
    ``source``'s benchmark with each configuration and each mix under its
    ``paths`` cut to a CPU's size, in the directory ``pbx`` searched first."""
    source = Path(source)
    root = Path(base) / "root"
    root.mkdir()
    bench = json.loads((source / "BENCHMARK.json").read_text())
    for path in bench["paths"]:
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        (root / path).symlink_to(source / path)
    for sub in ("configs", "traffic", "metrics", "graphs", "kinds"):
        (root / "pbx" / sub).mkdir(parents=True)
    for c in bench["configs"]:
        cfg = tiny_config(json.loads((source / c["file"]).read_text()))
        c["file"] = f"pbx/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for path in reversed(bench["paths"]):  # the first path's mix wins
        for mix in sorted((source / path / "traffic").glob("*.json")):
            cut = tiny_mix(json.loads(mix.read_text()))
            (root / "pbx/traffic" / mix.name).write_text(json.dumps(cut))
    bench["paths"] = ["pbx"] + bench["paths"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def family(name):
    """The ``chords`` function of the repository's graph family ``name``."""
    from portbench.harness import registry

    return registry.family(REPO, registry.load_benchmark(REPO), name)


def make_graph(spec, seed, device="cpu"):
    """(adjacency, stats) of ``spec`` drawn by its family's own file."""
    from portbench.harness import graphs

    return graphs.make_graph(spec, seed, device, family(spec["family"]))


@pytest.fixture
def bench_root(tmp_path):
    return make_root(tmp_path)


def run_cpu(root, bench, cell_name, seed=12345, trace=0, control=False,
            seconds=0.01, device="cpu"):
    """One whole run of the cell on the CPU: (result, forbidden loaded)."""
    from portbench.harness import cell

    return cell.run(str(root), bench, cell_name, seed, seconds, trace,
                    device, time.perf_counter(), control=control,
                    log=io.StringIO())
