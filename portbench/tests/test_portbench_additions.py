"""A configuration and a cell of an existing mix added as new files and
entries alone, as a change that adds a configuration adds them: the CPU
tests' set-up cuts the new configuration by its rules, the tests that
cover each cell collect the new cell, and a whole run of it passes, with
no file of the repository's ``portbench/`` changed."""

import json
import shutil
import subprocess
import sys

from conftest import REPO, TINY_VERTICES, make_root, run_cpu

# a ring of the 3n-chords family whose name no test has seen
NEW = {"name": "ring_7m",
       "source": "https://github.com/graphem/graphem-rapids-tpu/blob/main/experiments/bench_1m.py",
       "graph": {"family": "ring", "vertices": 7_000_000,
                 "chords": 21_000_000},
       "engine": {"n_components": 3, "L_min": 10.0, "k_attr": 0.5,
                  "k_inter": 0.1, "n_neighbors": 15, "sample_size": 512,
                  "init": "auto"},
       "reduced": [],
       "limits": {"spread": {"spread_gap": 0.0}}}
CELL = "ring_7m.spread"
# the tests that cover each cell, and those that cover each spread cell
PER_CELL = ("test_result_keys_and_compared_last",
            "test_sound_run_passes_and_control_fails",
            "test_control_fails_on_the_card",
            "test_spread_fault_is_caught",
            "test_spread_reader_on_a_traced_cpu_run")


def _files():
    return {p: p.read_bytes() for p in (REPO / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _checkout_with_a_new_cell(base):
    """A copy of the repository's benchmark with NEW and CELL added."""
    src = base / "src"
    shutil.copytree(REPO / "portbench", src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (src / "portbench/configs/ring_7m.json").write_text(json.dumps(NEW))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": NEW["name"], "source": NEW["source"],
         "file": "portbench/configs/ring_7m.json", "reduced": [],
         "why": "a ring plus 3n uniform chords"})
    bench["workloads"].append(
        {"name": CELL, "config": NEW["name"], "traffic": "spread_estimates",
         "chips": 1, "why": "spread estimates on the ring"})
    # the metrics its kind reports and whose readers serve it
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "skewed_1m.spread" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    return src


def test_a_new_configuration_and_cell_need_no_edit(tmp_path):
    before = _files()
    src = _checkout_with_a_new_cell(tmp_path)
    root, bench = make_root(tmp_path, source=src)
    tiny = json.loads((root / "pbx/configs/ring_7m.json").read_text())
    assert tiny["graph"] == {"family": "ring", "vertices": TINY_VERTICES,
                             "chords": 3 * TINY_VERTICES}
    assert tiny["engine"]["init"] == "chebyshev"
    result, loaded = run_cpu(root, bench, CELL)
    assert result["correct"] is True and result["failed"] == 0
    assert loaded == [] and "spread_estimates_per_s" in result["metrics"]
    # the copy's own tests collect the new cell wherever each cell is
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-c", str(REPO / "pyproject.toml"),
         "--rootdir", str(src), str(src / "portbench/tests")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    ids = p.stdout.splitlines()
    for test in PER_CELL:
        assert any(f"::{test}[" in i and CELL in i for i in ids), test
    assert _files() == before
