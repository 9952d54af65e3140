"""Shared set-up of the benchmark's CPU tests: a checkout-like root in a
temporary directory whose BENCHMARK.json names tiny copies of the cells'
configurations and mixes, so that a whole run fits a test on the CPU.

    python -m pytest portbench/tests          # from the repository root
"""

import io
import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# each configuration's graph cut to a CPU's size; the bin-fold kNN forced,
# as a card's 'auto' takes it at the real sizes
TINY = {"skewed_1m": {"vertices": 3000, "chords": 9000, "init": "chebyshev"},
        "ring_10m": {"vertices": 3000, "chords": 7500, "init": "random"}}
TINY_MIX = {"layout_calls": {"num_iterations": 2, "traced_calls": 1,
                             "check_steps": 2},
            "spread_estimates": {"traced_calls": 1, "check_calls": 2}}


def make_root(base):
    """(root, bench): a checkout-like directory under ``base``."""
    root = Path(base) / "root"
    root.mkdir()
    (root / "portbench").symlink_to(REPO / "portbench")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["paths"] = ["pbx", "portbench"]
    for sub in ("configs", "traffic", "metrics", "graphs", "kinds"):
        (root / "pbx" / sub).mkdir(parents=True)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        tiny = TINY[c["name"]]
        cfg["graph"].update(vertices=tiny["vertices"], chords=tiny["chords"])
        cfg["engine"].update(init=tiny["init"], backend="binfold")
        c["file"] = f"pbx/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, over in TINY_MIX.items():
        mix = json.loads((REPO / "portbench/traffic" / f"{name}.json")
                         .read_text())
        mix.update(over)
        (root / "pbx/traffic" / f"{name}.json").write_text(json.dumps(mix))
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
