"""Finds what a cell needs by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric:

- a cell's configuration is the file its ``configs`` entry names; its
  graph's ``family`` is drawn by ``<path>/graphs/<family>.py``, a module
  with ``chords(n, count, spec, gen, device)`` (``harness/graphs.py``);
- its traffic mix is ``<path>/traffic/<traffic>.json`` under one of the
  benchmark's ``paths``; the mix's ``kind`` names the runner that reads
  it, ``<path>/kinds/<kind>.py``, a module with a class ``Calls``
  (``harness/traffic.py`` states what it offers);
- each metric is read by ``<path>/metrics/<metric>.py``, a module with
  ``read(run)`` that returns a number, or None when the run holds nothing
  for it to read.

So a configuration, a graph family, a mix, a traffic kind or a metric is
added as a new file and a new entry in ``BENCHMARK.json``, with no edit to
a file that is there.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path


def load_benchmark(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench, name):
    return _entry(bench["workloads"], name, "workload")


def config(root, bench, name):
    entry = _entry(bench["configs"], name, "config")
    return json.loads((Path(root) / entry["file"]).read_text())


def _find(root, bench, sub, name, suffixes):
    for base in bench["paths"]:
        for suffix in suffixes:
            path = Path(root) / base / sub / f"{name}{suffix}"
            if path.is_file():
                return path
    raise FileNotFoundError(
        f"no {sub}/{name}{{{','.join(suffixes)}}} under {bench['paths']}")


def mix(root, bench, name):
    return json.loads(_find(root, bench, "traffic", name, (".json",))
                      .read_text())


def metrics(bench, cell_name, trace):
    """The metric entries a run of the cell reports: with ``trace`` the
    per-layer ones, else the end-to-end ones. A metric without a
    ``workloads`` list belongs to every cell (a per-layer one to every
    cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _module(root, bench, sub, name):
    """The module ``<path>/<sub>/<name>.py``, loaded once a file."""
    path = _find(root, bench, sub, name, (".py",)).resolve()
    mod_name = "portbench_" + re.sub(r"\W", "_", str(path))
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[mod_name]
            raise
    return sys.modules[mod_name]


def reader(root, bench, name):
    """The ``read`` function of the metric's own module."""
    return _module(root, bench, "metrics", name).read


def family(root, bench, name):
    """The ``chords`` function of the graph family's own module."""
    return _module(root, bench, "graphs", name).chords


def kind(root, bench, name):
    """The ``Calls`` class of the traffic kind's own module."""
    return _module(root, bench, "kinds", name).Calls
