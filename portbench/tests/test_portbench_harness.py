"""The harness: the result's keys, the registry of files, the look for a
card and the modules a run may load."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import REPO, run_cpu

from portbench.harness import cell, graphs, registry

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell_name", ["skewed_1m.layout", "ring_10m.layout",
                                       "skewed_1m.spread"])
def test_result_keys_and_compared_last(bench_root, cell_name):
    root, bench = bench_root
    result, loaded = run_cpu(root, bench, cell_name)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1 and loaded == []
    e2e = {m["name"] for m in registry.metrics(bench, cell_name, 0)}
    # the CPU has no device peak: every other end-to-end metric is there
    assert set(result["metrics"]) == e2e - {"peak_device_gib"}
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result)


def test_traced_result(bench_root):
    root, bench = bench_root
    result, _ = run_cpu(root, bench, "skewed_1m.layout", trace=1)
    assert {"tables_s", "spectral_s"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


DUMMY_FAMILY = """
import torch


def chords(n, count, spec, gen, device):
    a = torch.randint(0, n, (count,), generator=gen, device=device)
    return a, (a + int(spec["step"])) % n
"""

DUMMY_KIND = """
class Calls:
    sync_spans = False

    def __init__(self, mix, config, seed, device, spans):
        self.mix, self.notes, self.done = mix, {}, 0

    def setup_targets(self):
        return []

    def window_targets(self):
        return []

    def set_up(self, adj):
        self.adj = adj

    def warm_up(self):
        pass

    def call(self):
        self.done += 1
        return self.adj.nnz // 2

    def facts(self):
        return {"E": self.adj.nnz // 2}

    @staticmethod
    def counters():
        return {}

    def program_check_steps(self):
        return [self.adj.nnz]

    def release(self):
        pass

    def check(self, steps, control=False):
        asym = abs(self.adj - self.adj.T).sum()
        return {"asymmetry": float(asym) + abs(steps[0] - self.adj.nnz)}
"""


def test_new_config_mix_and_metric_are_files(bench_root):
    """A configuration, a graph family, a traffic mix, a traffic kind and a
    per-layer metric added as new files and entries: no existing file
    changes."""
    root, bench = bench_root
    before = {p: p.read_bytes() for p in (REPO / "portbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    pbx = root / "pbx"
    cfg = json.loads((root / "pbx/configs/ring_10m.json").read_text())
    cfg["graph"].update(vertices=2000, chords=3000)
    (pbx / "configs/dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "pbx/traffic/layout_calls.json").read_text())
    mix["num_iterations"] = 1
    (pbx / "traffic/dummy_mix.json").write_text(json.dumps(mix))
    (pbx / "metrics/dummy_metric.py").write_text(
        "def read(run):\n    return 40.0 + run.window['calls']\n")
    # a new graph family and a new traffic kind, each a file of its own
    (pbx / "graphs/dummy_family.py").write_text(DUMMY_FAMILY)
    (pbx / "kinds/dummy_kind.py").write_text(DUMMY_KIND)
    fam = {"name": "dummy_fam", "graph": {"family": "dummy_family",
                                          "vertices": 500, "chords": 700,
                                          "step": 2},
           "limits": {"dummy_kind": {"asymmetry": 0.0}}}
    (pbx / "configs/dummy_fam.json").write_text(json.dumps(fam))
    (pbx / "traffic/dummy_kind_mix.json").write_text(json.dumps(
        {"kind": "dummy_kind", "traced_calls": 2}))
    bench["configs"] += [
        {"name": "dummy_cfg", "source": "x", "file": "pbx/configs/dummy_cfg.json",
         "reduced": [], "why": "a test"},
        {"name": "dummy_fam", "source": "x", "file": "pbx/configs/dummy_fam.json",
         "reduced": [], "why": "a test"}]
    bench["workloads"] += [
        {"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
         "traffic": "dummy_mix", "chips": 1, "why": "a test"},
        {"name": "dummy_fam.dummy_kind_mix", "config": "dummy_fam",
         "traffic": "dummy_kind_mix", "chips": 1, "why": "a test"}]
    bench["per_layer"].append({"name": "dummy_metric", "unit": "x",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["dummy_cfg.dummy_mix",
                                             "dummy_fam.dummy_kind_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.load_benchmark(root)
    result, _ = run_cpu(root, bench, "dummy_cfg.dummy_mix", trace=1)
    assert result["metrics"]["dummy_metric"]["value"] == 41.0
    assert result["correct"] is True
    result, _ = run_cpu(root, bench, "dummy_fam.dummy_kind_mix", trace=1)
    assert result["metrics"]["dummy_metric"]["value"] == 42.0
    assert result["correct"] is True
    assert result["compared"] == {"asymmetry": {"value": 0.0, "limit": 0.0}}
    chords = registry.family(root, bench, "dummy_family")
    adj, _ = graphs.make_graph(fam["graph"], 3, "cpu", chords)
    i, j = adj.nonzero()
    # the ring and the family's chords, two steps apart, and nothing else
    assert set(((j - i) % 500).tolist()) == {1, 2, 498, 499}
    after = {p: p.read_bytes() for p in (REPO / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and fails; so it does
    in a directory that holds only BENCHMARK.json and the benchmark."""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", bare)
    shutil.copytree(REPO / "portbench", bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for where in (REPO, bare):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "skewed_1m.layout", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            env=env, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


def test_forbidden_names_compared_whole():
    loaded = ["graphem_rapids_torch", "graphem_rapids_torch.ops.knn",
              "graphem_rapids_tpu", "graphem_rapids_tpu.ops", "jax.numpy",
              "jaxtyping", "benchmarks", "bench", "benchmark", "networkx",
              "experiments.bench_10m", "flax.linen", "jaxlib"]
    assert cell.forbidden_modules(loaded) == sorted([
        "graphem_rapids_tpu", "graphem_rapids_tpu.ops", "jax.numpy",
        "benchmarks", "bench", "networkx", "experiments.bench_10m",
        "flax.linen", "jaxlib"])


def test_a_run_loads_no_forbidden_module(tmp_path):
    """Every module a run imports, in a process of its own: the harness,
    the reference, every metric reader and the port."""
    code = f"""
import sys, json
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / 'portbench/tests')!r})
from conftest import make_root, run_cpu
root, bench = make_root({str(tmp_path)!r})
for name in ("skewed_1m.layout", "skewed_1m.spread"):
    run_cpu(root, bench, name, trace=1)
from portbench.harness import cell
print(json.dumps(sorted(sys.modules)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    modules = json.loads(p.stdout.strip().splitlines()[-1])
    assert "graphem_rapids_torch" in modules
    assert cell.forbidden_modules(modules) == []


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench/reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for name in names:
                assert name.split(".")[0] in {
                    "numpy", "torch", "math", "dataclasses"}, (path, name)


def test_benchmark_json_follows_the_contract():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    cells = {w["name"]: w for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        family = cfg["graph"]["family"]
        assert (REPO / "portbench/graphs" / f"{family}.py").is_file()
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert w["chips"] == 1
        mix = REPO / "portbench/traffic" / f"{w['traffic']}.json"
        kind = json.loads(mix.read_text())["kind"]
        assert (REPO / "portbench/kinds" / f"{kind}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
    assert Path(REPO / bench["command"][1]).is_file()
